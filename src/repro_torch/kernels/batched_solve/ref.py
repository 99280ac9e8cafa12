"""Library oracle for the batched MNA solve (port of
`repro.kernels.batched_solve.ref`): the tests hold the Gauss-Jordan
kernel and its plain version against it."""
import torch


def batched_solve_ref(J, r):
    """J: (B, N, N), r: (B, N) -> x with J @ x = r."""
    return torch.linalg.solve(J, r[..., None])[..., 0]
