"""Modified nodal analysis: circuit build (python) -> dense tensors (torch).

Circuits here are the critical-path netlists of a memory bank (RBL
column with one active cell, bitline RC ladder, SA load): tens of nodes,
so dense (n, n) MNA is exact.

Nonlinear devices are stored as per-instance parameter tensors (vt0, n,
k', lambda, W, L, polarity), so a whole design-space batch is a batch
axis over those tensors. Voltage sources are Norton equivalents (G_BIG
to a piecewise-linear waveform), keeping the system pure nodal.

The channel-model functions below are the hot body of the fused Newton
engine; `csrc/fused_newton.cu` repeats `channel_current_and_grads`
formula for formula.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch._deferred import deferred
from repro_torch.core.spice.devices import sigmoid, softplus
from repro_torch.core.techfile import PHI_T, DeviceFlavor

G_BIG = 1e2     # Norton conductance for sources (S)
G_MIN = 1e-10   # diagonal gmin


def _on_signs(pol):
    """d(vgs_on)/d{vg, v_hi, v_lo} per polarity: NMOS (1, 0, -1),
    PMOS (-1, 1, 0)."""
    is_n = pol > 0
    one = torch.ones_like(pol)
    zero = torch.zeros_like(pol)
    return (torch.where(is_n, one, -one), torch.where(is_n, zero, one),
            torch.where(is_n, -one, zero))


def channel_current_raw(pol, vt0, n, kp, lam, w, l, vg, va, vb):
    """Vectorized signed current a->b; raw-parameter version of
    devices.channel_current (kept in lockstep; tested against it)."""
    def mag(v_hi, v_lo):
        vds = v_hi - v_lo
        vgs_on = torch.where(pol > 0, vg - v_lo, v_hi - vg)
        i_s = 2.0 * n * kp * (1.0 / l.clamp_min(1e-3)) * PHI_T ** 2
        a_ = (vgs_on - vt0) / (2.0 * n * PHI_T)
        b_ = (vgs_on - vt0 - n * vds) / (2.0 * n * PHI_T)
        return i_s * (softplus(a_) ** 2 - softplus(b_) ** 2) \
            * (1.0 + lam * vds)

    return w * torch.where(va >= vb, mag(va, vb), -mag(vb, va))


def _mag_all(pol, vt0, n, kp, lam, l, vg, v_hi, v_lo):
    """Magnitude m(v_hi, v_lo) and its partials (dm/dvg, dm/dhi, dm/dlo).

    With L2(x) = softplus(x)^2 and L2'(x) = 2 softplus(x) sigmoid(x):

        m = I_S [L2(a) - L2(b)] (1 + lam vds)
        a = (vgs_on - vt0) / (2 n phi_t)
        b = (vgs_on - vt0 - n vds) / (2 n phi_t)
    """
    den = 2.0 * n * PHI_T
    i_s = 2.0 * n * kp * (1.0 / l.clamp_min(1e-3)) * PHI_T ** 2
    vds = v_hi - v_lo
    vgs_on = torch.where(pol > 0, vg - v_lo, v_hi - vg)
    a_ = (vgs_on - vt0) / den
    b_ = (vgs_on - vt0 - n * vds) / den
    sp_a, sp_b = softplus(a_), softplus(b_)
    dl2a = 2.0 * sp_a * sigmoid(a_)
    dl2b = 2.0 * sp_b * sigmoid(b_)
    core = sp_a ** 2 - sp_b ** 2
    lam_f = 1.0 + lam * vds
    m = i_s * core * lam_f
    dvgs_dvg, dvgs_dhi, dvgs_dlo = _on_signs(pol)
    dm_dvg = i_s * (dl2a - dl2b) * dvgs_dvg / den * lam_f
    dm_dhi = i_s * ((dl2a * dvgs_dhi - dl2b * (dvgs_dhi - n)) / den
                    * lam_f + core * lam)
    dm_dlo = i_s * ((dl2a * dvgs_dlo - dl2b * (dvgs_dlo + n)) / den
                    * lam_f - core * lam)
    return m, dm_dvg, dm_dhi, dm_dlo


def channel_current_grads(pol, vt0, n, kp, lam, w, l, vg, va, vb):
    """Closed-form (di/dvg, di/dva, di/dvb) of `channel_current_raw`:
    the chain rule through (a, b, vds), with the branch (va >= vb picks
    which terminal is the source) selected exactly like the forward
    evaluation."""
    return channel_current_and_grads(pol, vt0, n, kp, lam, w, l,
                                     vg, va, vb)[1:]


def channel_current_and_grads(pol, vt0, n, kp, lam, w, l, vg, va, vb):
    """Fused (i, di/dvg, di/dva, di/dvb): the current and its 3x3 stamp
    row in one pass over the device tensors, sharing the softplus/sigmoid
    evaluations between the value and the partials."""
    f_m, f_dvg, f_dhi, f_dlo = _mag_all(pol, vt0, n, kp, lam, l, vg, va, vb)
    r_m, r_dvg, r_dhi, r_dlo = _mag_all(pol, vt0, n, kp, lam, l, vg, vb, va)
    fwd = va >= vb
    i = w * torch.where(fwd, f_m, -r_m)
    di_dvg = w * torch.where(fwd, f_dvg, -r_dvg)
    di_dva = w * torch.where(fwd, f_dhi, -r_dlo)
    di_dvb = w * torch.where(fwd, f_dlo, -r_dhi)
    return i, di_dvg, di_dva, di_dvb


@dataclass
class Circuit:
    """Builder. Node 0 is ground."""
    names: List[str] = field(default_factory=lambda: ["0"])
    res: List[tuple] = field(default_factory=list)    # (a, b, G)
    caps: List[tuple] = field(default_factory=list)   # (a, b, C)
    devs: List[dict] = field(default_factory=list)
    vsrcs: List[tuple] = field(default_factory=list)  # (node, wave_idx)
    probes: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        self._index = {n: i for i, n in enumerate(self.names)}

    def node(self, name: str) -> int:
        i = self._index.get(name)
        if i is None:
            i = len(self.names)
            self.names.append(name)
            self._index[name] = i
        return i

    def r(self, a, b, ohms):
        self.res.append((self.node(a), self.node(b), 1.0 / ohms))

    def c(self, a, b, farads):
        self.caps.append((self.node(a), self.node(b), farads))

    def dev(self, flavor: DeviceFlavor, w_um, l_um, g, a, b, name=""):
        self.devs.append({
            "pol": float(flavor.polarity), "vt0": flavor.vt0,
            "n": flavor.n_slope, "kp": flavor.k_prime,
            "lam": flavor.lambda_, "w": w_um, "l": l_um,
            "ig": flavor.i_gate_a_per_um,
            "g": self.node(g), "a": self.node(a), "b": self.node(b),
            "name": name,
        })
        # gate + junction caps as fixed linear caps
        cg = flavor.cg_f_per_um * w_um
        cj = flavor.cj_f_per_um * w_um
        self.caps.append((self.node(g), self.node(a), cg / 2))
        self.caps.append((self.node(g), self.node(b), cg / 2))
        self.caps.append((self.node(a), 0, cj))
        self.caps.append((self.node(b), 0, cj))

    def vsrc(self, node, wave_idx):
        self.vsrcs.append((self.node(node), wave_idx))

    def probe(self, label, node):
        self.probes[label] = self.node(node)

    # ---- assembly ----
    def build(self, device="cuda") -> "MNASystem":
        """Dense float64 MNA system with its tensors on `device`."""
        n = len(self.names) - 1  # exclude ground

        def idx(i):
            return i - 1  # ground dropped

        G = np.zeros((n, n))
        C = np.zeros((n, n))
        for a, b, g in self.res:
            for (i, j) in ((a, a), (b, b)):
                if i > 0:
                    G[idx(i), idx(j)] += g
            if a > 0 and b > 0:
                G[idx(a), idx(b)] -= g
                G[idx(b), idx(a)] -= g
        for a, b, c in self.caps:
            if a > 0:
                C[idx(a), idx(a)] += c
            if b > 0:
                C[idx(b), idx(b)] += c
            if a > 0 and b > 0:
                C[idx(a), idx(b)] -= c
                C[idx(b), idx(a)] -= c
        src_node = np.array([idx(nd) for nd, _ in self.vsrcs], np.int32)
        src_wave = np.array([w for _, w in self.vsrcs], np.int32)
        for nd in src_node:
            G[nd, nd] += G_BIG

        d = self.devs
        f64 = dict(dtype=torch.float64, device=device)
        dev_arr = {k: torch.tensor([x[k] for x in d], **f64)
                   for k in ("pol", "vt0", "n", "kp", "lam", "w", "l", "ig")}
        dev_idx = {k: np.array([idx(x[k]) for x in d], np.int32)
                   for k in ("g", "a", "b")}
        return MNASystem(torch.tensor(G, **f64), torch.tensor(C, **f64),
                         dev_arr, dev_idx, src_node, src_wave, n,
                         dict(self.probes), list(self.names))

    def build_stamps(self):
        """Unit-value incidence stamps of the LINEAR elements, so a whole
        lattice of structurally-identical circuits assembles as one einsum:

            G(g) = src_G + einsum('(b)r,rij->(b)ij', g, res_stamps)
            C(c) =         einsum('(b)c,cij->(b)ij', c, cap_stamps)

        where g/c are the per-point element-value vectors (in list order).
        Returns (res_stamps (nR,n,n), cap_stamps (nC,n,n), src_G (n,n)),
        float64 numpy."""
        n = len(self.names) - 1

        def stamp(a, b):
            s = np.zeros((n, n))
            if a > 0:
                s[a - 1, a - 1] += 1.0
            if b > 0:
                s[b - 1, b - 1] += 1.0
            if a > 0 and b > 0:
                s[a - 1, b - 1] -= 1.0
                s[b - 1, a - 1] -= 1.0
            return s

        res_stamps = np.stack([stamp(a, b) for a, b, _ in self.res]) \
            if self.res else np.zeros((0, n, n))
        cap_stamps = np.stack([stamp(a, b) for a, b, _ in self.caps]) \
            if self.caps else np.zeros((0, n, n))
        src_G = np.zeros((n, n))
        for nd, _ in self.vsrcs:
            src_G[nd - 1, nd - 1] += G_BIG
        return res_stamps, cap_stamps, src_G

    build_sparsity = deferred("Circuit.build_sparsity",
                              "Queue 1 item 3 (MNASparsity)")


@dataclass
class MNASystem:
    """The fields of the reference's MNASystem that the fused lattice
    path reads. G/C (n, n) and the per-device parameter tensors live on
    the device the circuit was built for; index maps stay numpy
    (ground = -1)."""
    G: torch.Tensor           # (n, n)
    C: torch.Tensor           # (n, n)
    dev: dict                 # per-instance param tensors
    didx: dict                # g/a/b node indices (ground = -1)
    src_node: np.ndarray
    src_wave: np.ndarray
    n: int
    probes: dict
    names: list
