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
from typing import Dict, List, Optional

import numpy as np
import torch

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
        den = 2.0 * n * PHI_T
        if not torch.is_tensor(den):
            # PyTorch's CUDA division by a host number multiplies by its
            # reciprocal, an ulp off the CPU's true division, and exp(a_)
            # magnifies that ulp; a tensor divisor divides on both
            den = torch.as_tensor(den, dtype=vgs_on.dtype,
                                  device=vgs_on.device)
        a_ = (vgs_on - vt0) / den
        b_ = (vgs_on - vt0 - n * vds) / den
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
    evaluations between the value and the partials. Both conduction
    directions (hi = va and hi = vb) go through one `_mag_all` call on
    stacked operands, elementwise the same arithmetic as two calls."""
    va, vb = torch.broadcast_tensors(va, vb)
    (f_m, r_m), (f_dvg, r_dvg), (f_dhi, r_dhi), (f_dlo, r_dlo) = _mag_all(
        pol, vt0, n, kp, lam, l, vg, torch.stack([va, vb]),
        torch.stack([vb, va]))
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

    def build_sparsity(self) -> "MNASparsity":
        """Full structural export for the sparse-Newton engine: the union
        Jacobian pattern plus the element-value projections, so a lattice
        group assembles its per-point pattern values as

            Gn = g_elems @ res_proj + src_nnz     # (B, nnz)
            Cn = c_elems @ cap_proj               # (B, nnz)

        (g_elems/c_elems in `res`/`caps` list order) without forming the
        dense (B, n, n) matrices `build_stamps` implies."""
        n = len(self.names) - 1
        pairs = set()

        def add(a, b):
            for i, j in ((a, a), (b, b), (a, b), (b, a)):
                if i > 0 and j > 0:
                    pairs.add((i - 1, j - 1))

        for a, b, _ in self.res:
            add(a, b)
        for a, b, _ in self.caps:
            add(a, b)
        d = self.devs
        didx = {k: np.array([x[k] - 1 for x in d], np.int32) if d
                else np.zeros((0,), np.int32) for k in ("g", "a", "b")}
        entries, pos, rows, cols, diag_pos, dev_pos = MNASparsity._build(
            n, pairs, didx, len(d))
        nnz = len(entries)

        def proj(elems):
            P = np.zeros((len(elems), nnz))
            for e, (a, b, _) in enumerate(elems):
                if a > 0:
                    P[e, pos[(a - 1, a - 1)]] += 1.0
                if b > 0:
                    P[e, pos[(b - 1, b - 1)]] += 1.0
                if a > 0 and b > 0:
                    P[e, pos[(a - 1, b - 1)]] -= 1.0
                    P[e, pos[(b - 1, a - 1)]] -= 1.0
            return P

        src_nnz = np.zeros((nnz,))
        for nd, _ in self.vsrcs:
            src_nnz[pos[(nd - 1, nd - 1)]] += G_BIG
        return MNASparsity(n, rows, cols, diag_pos, dev_pos,
                           res_proj=proj(self.res),
                           cap_proj=proj(self.caps), src_nnz=src_nnz)


@dataclass(frozen=True)
class MNASparsity:
    """Fixed sparsity structure of one topology's MNA Newton system.

    Within a topology group the circuit structure is identical across a
    whole design lattice (only element values vary), so the union
    nonzero pattern of J = C/h + G + dI/dv + gmin is a per-topology
    constant. This object holds that pattern plus the index maps the
    sparse-Newton engine (`kernels/batched_solve/sparse.py`) needs to
    re-stamp, factor and solve without dense (B, n, n) matrices. The maps
    are host numpy; values live in tensors on the system's device.

      rows/cols    COO pattern of the nnz stored entries (row-major
                   sorted; the LU schedule relies on the order being
                   deterministic, not on any particular sort)
      diag_pos     position of (i, i) for each node i
      dev_pos      (9, n_dev) positions of each device's 3x3 stamp
                   entries in `device_jacobian` row/col order
                   [(a,g),(a,a),(a,b),(b,g),(b,a),(b,b),(g,g),(g,a),
                   (g,b)]; -1 where the row or column is ground
      res_proj     (n_res, nnz) unit-stamp projection: Gn = g @ res_proj
                   reproduces build()'s resistor accumulation on the
                   pattern (None when built from_system: dense G/C are
                   projected directly instead)
      cap_proj     (n_cap, nnz) likewise for capacitor values
      src_nnz      (nnz,) Norton G_BIG source conductances on the
                   pattern (already folded into dense G by build())

    gmin is in no map: the solver adds G_MIN at diag_pos."""
    n: int
    rows: np.ndarray
    cols: np.ndarray
    diag_pos: np.ndarray
    dev_pos: np.ndarray
    res_proj: Optional[np.ndarray] = None
    cap_proj: Optional[np.ndarray] = None
    src_nnz: Optional[np.ndarray] = None
    # index tensors of the pattern per torch device (the sparse engine's)
    device_maps: dict = field(default_factory=dict, repr=False,
                              compare=False)

    @property
    def nnz(self) -> int:
        return len(self.rows)

    def pos(self) -> Dict[tuple, int]:
        return {(int(i), int(j)): p
                for p, (i, j) in enumerate(zip(self.rows, self.cols))}

    def project_dense(self, M: torch.Tensor) -> torch.Tensor:
        """Dense (..., n, n) matrix -> (..., nnz) pattern values, on M's
        device."""
        rows = torch.as_tensor(self.rows, dtype=torch.long, device=M.device)
        cols = torch.as_tensor(self.cols, dtype=torch.long, device=M.device)
        return M[..., rows, cols]

    @staticmethod
    def _build(n, pairs, didx, n_dev):
        pairs = set(pairs) | {(i, i) for i in range(n)}
        na, nb, ng = didx["a"], didx["b"], didx["g"]
        for d in range(n_dev):
            nodes = [int(x[d]) for x in (ng, na, nb)]
            pairs |= {(i, j) for i in nodes for j in nodes
                      if i >= 0 and j >= 0}
        entries = sorted(pairs)
        pos = {e: p for p, e in enumerate(entries)}
        rows = np.array([i for i, _ in entries], np.int32)
        cols = np.array([j for _, j in entries], np.int32)
        diag_pos = np.array([pos[(i, i)] for i in range(n)], np.int32)
        dev_pos = np.full((9, n_dev), -1, np.int32)
        combos = ((na, ng), (na, na), (na, nb), (nb, ng), (nb, na),
                  (nb, nb), (ng, ng), (ng, na), (ng, nb))
        for e, (ri, ci) in enumerate(combos):
            for d in range(n_dev):
                i, j = int(ri[d]), int(ci[d])
                if i >= 0 and j >= 0:
                    dev_pos[e, d] = pos[(i, j)]
        return entries, pos, rows, cols, diag_pos, dev_pos

    @staticmethod
    def from_system(system: "MNASystem") -> "MNASparsity":
        """Pattern-only structure from a built system: nonzeros of the
        numeric G/C (structural by construction: conductance stamps
        cannot cancel) plus the device stamps and the diagonal. Callers
        project dense G/C through `project_dense`; no element-value
        projections are available on this path."""
        G = system.G.cpu().numpy()
        C = system.C.cpu().numpy()
        pairs = {(int(i), int(j))
                 for i, j in zip(*np.nonzero((G != 0.0) | (C != 0.0)))}
        n_dev = int(system.dev["pol"].shape[0])
        _, _, rows, cols, diag_pos, dev_pos = MNASparsity._build(
            system.n, pairs, system.didx, n_dev)
        return MNASparsity(system.n, rows, cols, diag_pos, dev_pos)


@dataclass
class MNASystem:
    """Dense MNA system. G/C (n, n) and the per-device parameter tensors
    live on the device the circuit was built for; index maps stay numpy
    (ground = -1).

    The dense methods work over a leading lane axis: v is (..., n), and
    `with_params` may give G/C as (..., n, n) and device parameters as
    (..., n_dev), one row per lane, where the reference vmaps one
    system per lane. Scatter-adds drop ground rows and columns, as the
    reference's masked `.at[].add` does."""
    G: torch.Tensor           # (n, n)
    C: torch.Tensor           # (n, n)
    dev: dict                 # per-instance param tensors
    didx: dict                # g/a/b node indices (ground = -1)
    src_node: np.ndarray
    src_wave: np.ndarray
    n: int
    probes: dict
    names: list
    # index tensors of the dense methods, per torch device; shared by the
    # views `with_params` returns (the structure does not change)
    _plans: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.G.device

    def with_params(self, **over):
        """Override device parameter tensors (vt0, w, ...) and, with the
        special keys "G" and "C", the linear matrices (the per-point wire
        parasitics of a lattice run)."""
        f64 = dict(dtype=torch.float64, device=self.device)
        over = dict(over)
        G = torch.as_tensor(over.pop("G"), **f64) if "G" in over else self.G
        C = torch.as_tensor(over.pop("C"), **f64) if "C" in over else self.C
        dev = dict(self.dev)
        dev.update({k: torch.as_tensor(v, device=self.device)
                    for k, v in over.items()})
        return MNASystem(G, C, dev, self.didx, self.src_node,
                         self.src_wave, self.n, self.probes, self.names,
                         self._plans)

    def _plan(self, device) -> dict:
        """Gather and scatter indices of the dense methods on `device`:
        terminal gathers (ground reads the zero pad slot n) and, for the
        device currents, the Jacobian stamps and the sources, the kept
        (non-ground) entries and their targets."""
        key = str(device)
        plan = self._plans.get(key)
        if plan is not None:
            return plan
        n = self.n
        na, nb, ng = (np.asarray(self.didx[k]) for k in ("a", "b", "g"))
        term = np.concatenate([ng, na, nb])
        cur = np.concatenate([na, nb, ng])
        # stamp order: rows a, b, g; columns g, a, b
        rows = np.concatenate([na, na, na, nb, nb, nb, ng, ng, ng])
        cols = np.concatenate([ng, na, nb, ng, na, nb, ng, na, nb])
        flat = np.where((rows >= 0) & (cols >= 0), rows * n + cols, -1)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long,
                                   device=device)

        f64 = dict(dtype=torch.float64, device=device)
        plan = self._plans[key] = {
            # per-row coefficients of the gate-leak current and
            # conductance in the KCL rows and stamps (see device_jacobian)
            "cur_coef": torch.tensor([[-0.5], [-0.5], [1.0]], **f64),
            "jac_coef": torch.tensor([[-0.5], [0.25], [0.25], [-0.5], [0.25],
                                      [0.25], [1.0], [-0.5], [-0.5]], **f64),
            "gmin": G_MIN * torch.eye(n, **f64),
            "term": t(np.where(term >= 0, term, n)),
            "cur_keep": t(np.nonzero(cur >= 0)[0]), "cur_at": t(cur[cur >= 0]),
            "jac_keep": t(np.nonzero(flat >= 0)[0]),
            "jac_at": t(flat[flat >= 0]),
            "src_node": t(self.src_node), "src_wave": t(self.src_wave)}
        return plan

    def _v_of(self, v, node_idx):
        # ground (-1) reads as 0.0
        vg = torch.cat([v, v.new_zeros(v.shape[:-1] + (1,))], dim=-1)
        idx = np.asarray(node_idx)
        return vg[..., torch.as_tensor(np.where(idx >= 0, idx, self.n),
                                       dtype=torch.long, device=v.device)]

    def _device_terms(self, v, jacobian: bool):
        """(device currents (..., n), device Jacobian (..., n, n) or None)
        with the channel model evaluated once."""
        n, d = self.n, self.dev
        plan = self._plan(v.device)
        n_dev = d["pol"].shape[-1]
        vx = torch.cat([v, v.new_zeros(v.shape[:-1] + (1,))], dim=-1)
        vg, va, vb = vx[..., plan["term"]].split(n_dev, dim=-1)
        args = (d["pol"], d["vt0"], d["n"], d["kp"], d["lam"], d["w"],
                d["l"], vg, va, vb)
        if jacobian:
            i_ab, di_dvg, di_dva, di_dvb = channel_current_and_grads(*args)
        else:
            i_ab = channel_current_raw(*args)
        # gate leakage: gate -> (a+b)/2
        i_g = d["ig"] * d["w"] * (vg - 0.5 * (va + vb)) / 1.1
        i_ab, i_g = torch.broadcast_tensors(i_ab, i_g)
        # KCL rows a, b, g: (i_ab, -i_ab, 0) + (-1/2, -1/2, 1) i_g
        cur = (torch.stack([i_ab, -i_ab, torch.zeros_like(i_ab)], dim=-2)
               + plan["cur_coef"] * i_g[..., None, :]).flatten(-2)
        out = cur.new_zeros(cur.shape[:-1] + (n,)).index_add(
            -1, plan["cur_at"], cur[..., plan["cur_keep"]])
        if not jacobian:
            return out, None
        gg = d["ig"] * d["w"] / 1.1
        d3 = torch.stack([di_dvg, di_dva, di_dvb], dim=-2)
        vals = (torch.cat([d3, -d3, torch.zeros_like(d3)], dim=-2)
                + plan["jac_coef"] * gg[..., None, :]).flatten(-2)
        J = vals.new_zeros(vals.shape[:-1] + (n * n,)).index_add(
            -1, plan["jac_at"], vals[..., plan["jac_keep"]])
        return out, J.reshape(J.shape[:-1] + (n, n))

    def device_currents(self, v):
        """KCL residual contribution of all devices: (..., n) currents
        LEAVING each node."""
        if self.dev["pol"].shape[-1] == 0:
            return torch.zeros_like(v)
        return self._device_terms(v, jacobian=False)[0]

    def source_currents(self, wave_v):
        """Norton injections for sources; wave_v: (..., n_waves) values
        now."""
        out = wave_v.new_zeros(wave_v.shape[:-1] + (self.n,))
        if len(self.src_node) == 0:
            return out
        plan = self._plan(wave_v.device)
        return out.index_add(-1, plan["src_node"],
                             G_BIG * wave_v[..., plan["src_wave"]])

    def device_jacobian(self, v):
        """d(device_currents)/dv as dense (..., n, n), assembled from the
        per-device 3x3 analytic stamps in one pass. With channel partials
        (di/dvg, di/dva, di/dvb) and gate-leak conductance gg = ig*w/1.1,
        the KCL rows stamp as

            row a (+i_ab - i_g/2):  [di_dvg - gg/2, di_dva + gg/4, di_dvb + gg/4]
            row b (-i_ab - i_g/2):  [-di_dvg - gg/2, -di_dva + gg/4, -di_dvb + gg/4]
            row g (+i_g):           [gg, -gg/2, -gg/2]

        (columns ordered g, a, b)."""
        if self.dev["pol"].shape[-1] == 0:
            return v.new_zeros(v.shape + (self.n,))
        return self._device_terms(v, jacobian=True)[1]

    def _assemble(self, v, v_prev, h, wave_v, i_dev, dJ):
        """J = C/h + G + dI/dv + gmin and the backward-Euler residual from
        the device terms; either term may be None (not wanted)."""
        h = torch.as_tensor(h, dtype=v.dtype, device=v.device)
        J = r = None
        if dJ is not None:
            J = self.C / h[..., None, None] + self.G + dJ \
                + self._plan(v.device)["gmin"].to(v.dtype)
        if i_dev is not None:
            r = (_matvec(self.C, (v - v_prev) / h[..., None])
                 + _matvec(self.G, v) + i_dev
                 - self.source_currents(wave_v) + G_MIN * v)
        return J, r

    def jacobian(self, v, h):
        """Analytic MNA Newton Jacobian J = C/h + G + dI/dv + gmin; h is
        a scalar or one step per lane (...,)."""
        return self._assemble(v, None, h, None, None,
                              self.device_jacobian(v))[0]

    def residual(self, v, v_prev, h, wave_v):
        """Backward-Euler KCL residual (..., n)."""
        return self._assemble(v, v_prev, h, wave_v, self.device_currents(v),
                              None)[1]

    def newton_system(self, v, v_prev, h, wave_v):
        """(jacobian(v, h), residual(v, v_prev, h, wave_v)) with the
        channel model evaluated once; the same values as the two calls."""
        if self.dev["pol"].shape[-1] == 0:
            return self.jacobian(v, h), self.residual(v, v_prev, h, wave_v)
        i_dev, dJ = self._device_terms(v, jacobian=True)
        return self._assemble(v, v_prev, h, wave_v, i_dev, dJ)


def _matvec(M, x):
    """(..., n, n) @ (..., n) -> (..., n), broadcasting the lane axes."""
    return (M @ x[..., None])[..., 0]
