"""Blocking device-to-host transfers the serving engine made (its own
`host_syncs` counter) per request completed, over the window and its
drain."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["completed"]:
        return None
    return ctx["host_syncs"] / ctx["completed"]
