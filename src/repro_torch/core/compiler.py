"""Bank compilation: config -> Report (the compiler's output set).

    rep = compile_bank(BankConfig(32, 32, cell="gc2t_nn"), simulate=True,
                       solver="pallas")
    rep.write("out/gc32x32")

Produces:
  * bank organization + module inventory + floorplan manifest (JSON);
  * the critical-path SPICE netlist of the read column (.sp text);
  * timing (analytic, plus the transient-simulated sense time with
    `simulate=True`), power and retention reports.

Retention, and with `simulate=True` `timing.simulate_read`, run on
`device`; with solver="pallas" each Newton solve of that transient is one
launch of the Gauss-Jordan kernel (`kernels/batched_solve`).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

from repro_torch._deferred import deferred
from repro_torch.core import power as power_mod
from repro_torch.core import retention as ret_mod
from repro_torch.core import timing as timing_mod
from repro_torch.core.bank import Bank, BankConfig, build_bank
from repro_torch.core.spice.mna import Circuit


def circuit_to_spice(ckt: Circuit, title: str) -> str:
    """Emit a SPICE netlist text for a built Circuit. The header line is
    the reference compiler's, so both packages write the same file."""
    lines = [f"* {title} (OpenGCRAM-JAX syn40)", ".option post"]
    for i, (a, b, g) in enumerate(ckt.res):
        lines.append(f"R{i} {ckt.names[a]} {ckt.names[b]} {1.0/g:.6g}")
    for i, (a, b, c) in enumerate(ckt.caps):
        lines.append(f"C{i} {ckt.names[a]} {ckt.names[b]} {c:.6g}")
    for i, d in enumerate(ckt.devs):
        model = "nch" if d["pol"] > 0 else "pch"
        lines.append(
            f"M{i} {ckt.names[d['a']]} {ckt.names[d['g']]} "
            f"{ckt.names[d['b']]} 0 {model} w={d['w']:.3g}u l={d['l']:.3g}u "
            f"* vt0={d['vt0']:.3g}")
    for i, (node, wid) in enumerate(ckt.vsrcs):
        lines.append(f"V{i} {ckt.names[node]} 0 PWL_WAVE_{wid}")
    lines.append(".end")
    return "\n".join(lines)


@dataclass
class Report:
    cfg: BankConfig
    bank: Bank
    timing: timing_mod.Timing
    power: power_mod.Power
    retention: Optional[ret_mod.Retention]
    t_cell_sim_s: Optional[float]
    netlists: dict          # name -> spice text

    def summary(self) -> dict:
        out = {"config": {
            "word_size": self.cfg.word_size, "num_words": self.cfg.num_words,
            "cell": self.cfg.cell, "wwlls": self.cfg.wwlls,
            "write_vt": self.cfg.write_vt},
            "bank": self.bank.summary(),
            "timing": self.timing.as_dict(),
            "power": self.power.as_dict()}
        if self.retention:
            out["retention"] = self.retention.as_dict()
        if self.t_cell_sim_s is not None:
            out["t_cell_sim_s"] = self.t_cell_sim_s
            out["analytic_vs_sim_dev"] = abs(
                self.timing.t_cell_s - self.t_cell_sim_s) / max(
                self.t_cell_sim_s, 1e-15)
        return out

    def as_dict(self) -> dict:
        return self.summary()

    def write(self, outdir: str):
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "report.json"), "w") as f:
            json.dump(self.summary(), f, indent=1)
        with open(os.path.join(outdir, "floorplan.json"), "w") as f:
            json.dump(self.bank.plan.manifest(), f, indent=1)
        for name, text in self.netlists.items():
            with open(os.path.join(outdir, f"{name}.sp"), "w") as f:
                f.write(text)
        return outdir


def compile_bank(cfg: BankConfig, *, simulate: bool = False,
                 solver: str = "jnp", device="cuda") -> Report:
    """Core compile flow: bank build, analytic timing, retention (gain
    cells) on `device`, read-column netlist, and with `simulate=True` the
    transient read on `device`; then power at the timing's f_max."""
    bank = build_bank(cfg)
    t = timing_mod.analyze(bank)
    ret = None
    t_sim = None
    netlists = {}
    if bank.is_gc:
        ret = ret_mod.analyze(bank.cell, cfg.tech, wwlls=cfg.wwlls,
                              wwl_boost=cfg.wwl_boost, device=device)
        ckt, _ = timing_mod.read_netlist(bank)
        netlists["read_column"] = circuit_to_spice(
            ckt, f"{cfg.cell} {bank.rows}x{bank.cols} read column")
        if simulate:
            t_sim, _ = timing_mod.simulate_read(bank, solver=solver,
                                                device=device)
    p = power_mod.analyze(bank, t.f_max_hz,
                          t_ret_s=ret.t_ret_s if ret else None)
    return Report(cfg, bank, t, p, ret, t_sim, netlists)


# The reference's deprecated facade runs through `repro.api.Session`.
GCRAMCompiler = deferred("compiler.GCRAMCompiler", "Queue 1 item 9 (API)")
