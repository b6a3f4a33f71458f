"""Direct (closed-form) RBF fitting: kernel matrix + regularized solve.

Port of ``irbfn_tpu/models/fit.py``. The WCRBF output is linear in the head
weights once centers, widths and the region indicator are fixed, so the
weights solve in closed form: the classical RBF-interpolation normal
equations, accumulated over the table in chunks.

Feature modes:

- ``shared``:     features g(x) = sum_r gamma_r(x) phi_r(x)  (K,), the
  WCRBFNet shared-head parameterization;
- ``per_region``: features G(x) = [gamma_r(x) phi_rk(x) ; gamma_r(x)]
  (R*K + R,), per-region output heads over normalised gammas.

What the numbers depend on, and what is kept from the JAX package:

- a chunk's gram ``P^T diag(w) P`` is one matrix product in the table's
  dtype with exact products (TF32 is off in this package: it would destroy
  the gram's conditioning and NaN the solve); ``fit_per_region`` rounds it
  to f32, the table's precision;
- the chunks are summed in **f64**, on the device (summing them in f32
  loses the gram's small eigenvalues), and the small ``(K+1)^2`` system is
  solved in f64 (``torch.linalg.solve``) with the trace-relative ridge
  ``reg * trace(A) / (K+1)``: G^T G grows with the row count, so an
  absolute ridge would vanish on large tables;
- padded rows weigh 0 (``device_table`` pads; gathers never read the pad);
- ``choose_centers`` draws with ``np.random.default_rng(seed)`` in the JAX
  package's order of calls, so one table and seed give the same centers
  bit for bit in both packages.

Nothing here compiles per shape, so the tail chunk is simply shorter.
Every function takes numpy arrays or tensors and runs on ``device`` (None:
the card); a tensor argument with ``device=None`` stays where it is.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from irbfn_tpu_torch._device import resolve_device, wait_clock
from irbfn_tpu_torch.models.kernels import get_basis
from irbfn_tpu_torch.models.wcrbf import rbf_distances, region_activation


class DirectFit(NamedTuple):
    weights: torch.Tensor  # (Kf, O)
    bias: torch.Tensor  # (O,)
    centers: torch.Tensor  # (R, K, F)
    log_sigs: torch.Tensor  # (R, K)
    mode: str
    input_scale: Optional[tuple] = None  # (F,) metric weights

    def predict(self, x, lb, ub, delta, activation_idx, basis_func):
        x = torch.as_tensor(x, device=self.weights.device)
        feats = rbf_features(x, self.centers, self.log_sigs, lb, ub, delta,
                             activation_idx, basis_func, mode=self.mode,
                             input_scale=self.input_scale)
        return (feats @ self.weights.to(feats.dtype)
                + self.bias.to(feats.dtype))


@torch.no_grad()
def install_fit(model, fit: DirectFit):
    """Write a fit into a ``WCRBFNet`` of the matching ``head_mode``:
    centers, log-widths, and the solved weights as the Dense head. In place,
    so the model's packed-operand cache sees new versions."""
    model.centers.copy_(fit.centers)
    model.log_sigs.copy_(fit.log_sigs)
    model.head_kernel.copy_(fit.weights)
    model.head_bias.copy_(fit.bias)
    return model


def _device_of(x, device) -> torch.device:
    """A tensor stays where it is unless ``device`` names a place; anything
    else goes to ``resolve_device(device)`` (the card by default)."""
    if torch.is_tensor(x) and device is None:
        return x.device
    return resolve_device(device)


def _tensor(a) -> torch.Tensor:
    """``a`` as a tensor; a read-only numpy array (a view of another
    library's buffer) is copied, since torch shares memory with numpy."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a)


def _like(a, ref: torch.Tensor) -> torch.Tensor:
    return _tensor(a).to(device=ref.device, dtype=ref.dtype)


def rbf_features(x, centers, log_sigs, lb, ub, delta, activation_idx,
                 basis_func, mode: str = "shared", input_scale=None):
    """Region-blended RBF feature map: x (B, F) -> (B, K) for ``shared`` or
    (B, R*K + R) for ``per_region``, the WCRBFNet head's feature layouts, so
    solved weights load into the net's Dense head.

    ``per_region`` uses NORMALISED region weights (partition of unity) and
    appends the gamma columns themselves (the per-region bias features).
    The region indicator gates on RAW inputs (bounds are in raw units);
    ``input_scale`` only reshapes the RBF distance metric."""
    basis = get_basis(basis_func)
    centers, log_sigs, lb, ub, delta = (_like(t, x) for t in (
        centers, log_sigs, lb, ub, delta))
    gamma = region_activation(x, lb, ub, delta, activation_idx)  # (B, R)
    if mode == "per_region":
        gamma = gamma / (gamma.sum(-1, keepdim=True) + 1e-9)
    phi = basis(rbf_distances(x, centers, log_sigs, input_scale=input_scale))
    if mode == "shared":
        return torch.einsum("br,brk->bk", gamma, phi)
    weighted = gamma[:, :, None] * phi  # (B, R, K)
    return torch.cat([weighted.reshape(x.shape[0], -1), gamma], dim=-1)


def _scale_tuple(input_scale):
    return (None if input_scale is None
            else tuple(float(v) for v in np.asarray(input_scale)))


def _solve_ridge(A: torch.Tensor, b: torch.Tensor, reg: float):
    """``(A + reg trace(A)/n I)^-1 b`` in f64 on A's device."""
    n = A.shape[0]
    reg_eff = reg * torch.trace(A) / n
    return torch.linalg.solve(
        A + reg_eff * torch.eye(n, dtype=A.dtype, device=A.device), b)


@torch.no_grad()
def fit_direct(x, y, centers, log_sigs, lb, ub, delta, activation_idx,
               basis_func, reg: float = 1e-5, mode: str = "shared",
               chunk: int = 65536, input_scale=None, sample_weight=None,
               device=None) -> DirectFit:
    """Solve min_W sum_i w_i ||G(x_i) W + b - y_i||^2 + reg ||W||^2 in
    closed form.

    The normal equations are accumulated over ``chunk``-row blocks (the
    (N, Kf) design matrix never materialises), then solved as one
    (Kf+1, Kf+1) system with the bias folded in as a constant feature.
    ``sample_weight`` (N,) optionally weights rows (e.g. ``tube_weights``).
    ``reg`` is RELATIVE to the mean diagonal of G^T G.

    NOTE ``mode="per_region"`` here builds the FULL (R*K+R)^2 gram, only
    affordable for small R*K; for real tables use ``fit_per_region``.
    """
    dev = _device_of(x, device)
    x = _tensor(x).to(dev)
    y = _tensor(y).to(dev, x.dtype)
    centers, log_sigs = _like(centers, x), _like(log_sigs, x)
    w = None if sample_weight is None else _like(sample_weight, x)
    R, K, _ = centers.shape
    kf = K if mode == "shared" else R * (K + 1)
    gtg = torch.zeros((kf + 1, kf + 1), dtype=torch.float64, device=dev)
    gty = torch.zeros((kf + 1, y.shape[1]), dtype=torch.float64, device=dev)
    for i0 in range(0, x.shape[0], chunk):
        xb, yb = x[i0:i0 + chunk], y[i0:i0 + chunk]
        g1 = torch.cat(
            [rbf_features(xb, centers, log_sigs, lb, ub, delta,
                          activation_idx, basis_func, mode=mode,
                          input_scale=input_scale),
             torch.ones((xb.shape[0], 1), dtype=x.dtype, device=dev)], dim=1)
        gw = g1 if w is None else g1 * w[i0:i0 + chunk, None]
        gtg += (gw.T @ g1).double()
        gty += (gw.T @ yb).double()
    wb = _solve_ridge(gtg, gty, reg).to(x.dtype)
    return DirectFit(wb[:-1], wb[-1], centers, log_sigs, mode,
                     _scale_tuple(input_scale))


def device_table(x, y=None, chunk: int = 262144, device=None):
    """Put a (large) table on the device ONCE, as f32, zero-padded to a
    multiple of ``chunk`` rows. Returns (x_dev, y_dev, n_rows). The fitters
    below take these resident tensors and gather each chunk's rows on the
    device, so only row indices are made per chunk."""
    dev = resolve_device(device)
    n = x.shape[0]
    n_pad = -(-n // chunk) * chunk

    def put(a):
        out = torch.zeros((n_pad, a.shape[1]), dtype=torch.float32,
                          device=dev)
        out[:n] = torch.as_tensor(a).to(dev, torch.float32)
        return out

    return put(x), (None if y is None else put(y)), n


def _box_mask(x_dev: torch.Tensor, n: int, act, lo, hi) -> torch.Tensor:
    """Rows of ``x_dev[:n]`` inside the box [lo, hi] on the dims ``act``,
    compared in f64 against f64 bounds: what numpy's comparison of an f32
    table with f64 bounds computes, so the same rows are selected."""
    m = torch.ones((n,), dtype=torch.bool, device=x_dev.device)
    for j, d in enumerate(act):
        col = x_dev[:n, d].double()
        m &= (col >= float(lo[j])) & (col <= float(hi[j]))
    return m


@torch.no_grad()
def fit_per_region(x, y, centers, log_sigs, lb, ub, delta, activation_idx,
                   basis_func, reg: float = 1e-5, chunk: int = 65536,
                   input_scale=None, sample_weight=None,
                   margin_steps: float = 2.0, grid_steps=None,
                   x_dev=None, y_dev=None, device=None,
                   timings: Optional[dict] = None) -> DirectFit:
    """Per-region output heads at shared-fit cost.

    The full ``mode="per_region"`` normal equations are (R*K+R)^2, R^2
    times the shared fit's operations. But region r's normalised weight is
    ~0 outside its (overlapped) box, so the gram's cross-region blocks
    vanish and the problem decouples into R independent weighted least
    squares, each over only the rows NEAR region r:

        min_{W_r,b_r} sum_i w_i gamma_n_ri || phi_r(x_i) W_r + b_r - y_i ||^2

    (the local-model / Takagi-Sugeno fit). The blended prediction
    sum_r gamma_n_r (phi_r W_r + b_r) is exactly ``rbf_features
    (mode="per_region") @ W``, so the result loads into a
    ``WCRBFNet(head_mode="per_region")`` Dense head: region r's weights at
    rows ``r*K..(r+1)*K`` and its bias at row ``R*K + r``; the returned
    ``bias`` is zero.

    Rows are selected per region by a box test: within ``margin_steps`` grid
    steps of the region box (the tanh gate's tail; ``grid_steps`` (D,)
    defaults to 4/delta, about one grid step). With ``x_dev``/``y_dev``
    from ``device_table`` the test, the row gather and the whole fit run on
    the device and nothing returns to the host but each region's row count;
    otherwise the test is numpy's and each chunk's rows are uploaded.

    ``timings``, if given, receives the seconds spent in the box tests, the
    gram passes and the solves (each waits for the device, which the fit
    itself never does).
    """
    basis = get_basis(basis_func)
    resident = x_dev is not None
    dev = x_dev.device if resident else resolve_device(device)
    x_np = None if resident else np.asarray(x)
    lb_np = np.asarray(torch.as_tensor(lb).cpu(), np.float64)
    ub_np = np.asarray(torch.as_tensor(ub).cpu(), np.float64)
    delta_np = np.asarray(torch.as_tensor(delta).cpu(), np.float64)
    n = x.shape[0]
    act = [int(d) for d in activation_idx]
    if grid_steps is None:
        grid_steps = 4.0 / delta_np
    margin = margin_steps * np.asarray(grid_steps, np.float64)

    if resident:
        if y_dev is None:
            raise ValueError("fit_per_region: x_dev needs its y_dev "
                             "(both from device_table)")
        dtype = x_dev.dtype
        y_np = None
        w_dev = (None if sample_weight is None else
                 torch.as_tensor(np.asarray(sample_weight, np.float32)).to(
                     dev))
    else:
        dtype = torch.as_tensor(x_np[:1]).dtype
        y_np = np.asarray(y)
        sw_np = (None if sample_weight is None
                 else np.asarray(sample_weight, np.float32))
    ref = torch.empty((), dtype=dtype, device=dev)
    centers_d, log_sigs_d, lb_d, ub_d, delta_d = (_like(t, ref) for t in (
        centers, log_sigs, lb, ub, delta))
    R, K, _ = centers_d.shape
    O = (y_dev if resident else y_np).shape[1]
    clock = _Clock(dev, timings)

    def gram(xs, ys, ws, r):
        # weighted gram of one region over one chunk: A = P^T diag(w) P with
        # P = [phi_r, 1] and w = gamma_n_r * sample_weight, rounded to f32
        gamma = region_activation(xs, lb_d, ub_d, delta_d, act)
        gamma = gamma / (gamma.sum(-1, keepdim=True) + 1e-9)
        d = rbf_distances(xs, centers_d[r:r + 1], log_sigs_d[r:r + 1],
                          input_scale=input_scale)[:, 0, :]
        p1 = torch.cat([basis(d), torch.ones((xs.shape[0], 1), dtype=dtype,
                                             device=dev)], dim=1)
        w = gamma[:, r] if ws is None else gamma[:, r] * ws
        pw = p1 * w[:, None]
        return (pw.T @ p1).float().double(), (pw.T @ ys).float().double()

    weights = torch.zeros((R * K + R, O), dtype=torch.float32, device=dev)
    for r in range(R):
        lo, hi = lb_np[r] - margin, ub_np[r] + margin
        A = torch.zeros((K + 1, K + 1), dtype=torch.float64, device=dev)
        b = torch.zeros((K + 1, O), dtype=torch.float64, device=dev)
        clock.start()
        if resident:
            idx = torch.nonzero(_box_mask(x_dev, n, act, lo, hi))[:, 0]
            n_rows = idx.numel()
        else:
            xa = x_np[:, act]
            m = np.all((xa >= lo) & (xa <= hi), axis=1)
            xs_r, ys_r = x_np[m], y_np[m]
            ws_r = None if sw_np is None else sw_np[m]
            n_rows = xs_r.shape[0]
        clock.stop("mask")
        if timings is not None:
            timings["row_visits"] = timings.get("row_visits", 0) + n_rows
        for i0 in range(0, n_rows, chunk):
            if resident:
                blk = idx[i0:i0 + chunk]
                xs, ys = x_dev[blk], y_dev[blk]
                ws = None if w_dev is None else w_dev[blk]
            else:
                xs = torch.as_tensor(xs_r[i0:i0 + chunk]).to(dev)
                ys = torch.as_tensor(ys_r[i0:i0 + chunk]).to(dev, dtype)
                ws = (None if ws_r is None else
                      torch.as_tensor(ws_r[i0:i0 + chunk]).to(dev, dtype))
            Ab, bb = gram(xs, ys, ws, r)
            A += Ab
            b += bb
        clock.stop("gram")
        sol = _solve_ridge(A, b, reg).float()
        weights[r * K:(r + 1) * K] = sol[:-1]
        weights[R * K + r] = sol[-1]
        clock.stop("solve")
        if resident:
            print(f"fit_per_region: region {r + 1}/{R} "
                  f"({n_rows:,} rows)", flush=True)
    return DirectFit(weights, torch.zeros((O,), dtype=torch.float32,
                                          device=dev),
                     centers_d, log_sigs_d, "per_region",
                     _scale_tuple(input_scale))


class _Clock:
    """Seconds per named part, into ``timings``; waits for the device at
    each reading, and does nothing when ``timings`` is None."""

    def __init__(self, device, timings):
        self.device, self.timings = device, timings
        self.t0 = 0.0

    def start(self):
        if self.timings is not None:
            self.t0 = wait_clock(self.device)

    def stop(self, name: str):
        if self.timings is not None:
            t = wait_clock(self.device)
            self.timings[name] = self.timings.get(name, 0.0) + t - self.t0
            self.t0 = t


@torch.no_grad()
def tube_weights(x, tube, input_scale=None, bandwidth: float = 1.0,
                 floor: float = 0.05, chunk: int = 262144,
                 max_tube: int = 2048, seed: int = 0, x_dev=None,
                 device=None) -> np.ndarray:
    """Row weights from proximity to the closed-loop operating tube.

    ``tube`` (M, F) are net-input states visited by a planner that already
    laps. Each table row gets

        w_i = floor + (1 - floor) * exp(-0.5 * d_i^2 / bandwidth^2)

    with d_i the distance from row i to the NEAREST tube state in the
    ``input_scale`` metric (proximity to the tube manifold, deliberately
    not a density). ``floor`` keeps off-tube rows in the fit. Distances are
    one (chunk, M) product per chunk; the weights return as host numpy for
    center sampling. Pass ``x_dev`` (``device_table``) to read the rows
    from the resident table."""
    tube = np.asarray(tube, np.float32)
    if tube.shape[0] > max_tube:
        rng = np.random.default_rng(seed)
        tube = tube[rng.choice(tube.shape[0], max_tube, replace=False)]
    s = (np.ones(tube.shape[1], np.float32) if input_scale is None
         else np.asarray(input_scale, np.float32))
    dev = x_dev.device if x_dev is not None else resolve_device(device)
    t_d = torch.as_tensor(tube * s).to(dev)
    s_d = torch.as_tensor(s).to(dev)
    n = x.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    x_np = None if x_dev is not None else np.asarray(x, np.float32)
    t_sq = (t_d * t_d).sum(-1)
    for i0 in range(0, n, chunk):
        stop = min(i0 + chunk, n)
        xc = (x_dev[i0:stop] if x_dev is not None
              else torch.as_tensor(x_np[i0:stop]).to(dev))
        xs = xc * s_d
        d2 = (xs * xs).sum(-1, keepdim=True) - 2.0 * xs @ t_d.T + t_sq
        out[i0:stop] = d2.min(dim=-1).values
    out = out.cpu().numpy()
    return (floor + (1.0 - floor)
            * np.exp(-0.5 * np.maximum(out, 0.0) / bandwidth**2))


def data_scale(x, activation_idx=()) -> np.ndarray:
    """Per-dim metric weights 1/std from the data (constant dims -> 1): all
    input dims contribute comparably to kernel distances whatever their
    physical units."""
    std = np.asarray(x).std(axis=0)
    return np.where(std > 1e-9, 1.0 / np.maximum(std, 1e-9), 1.0)


def choose_centers(x, num_kernels: int, num_regions: int, seed: int = 0,
                   jitter: float = 1e-3, input_scale=None, lb=None, ub=None,
                   activation_idx=None, width_neighbors: int = 4,
                   width_factor: float = 2.0, probs=None, x_dev=None,
                   device=None):
    """Pick per-region centers as a random subset of the rows BELONGING to
    that region (hard box test on the activation dims; global sampling when
    no bounds are given), with per-kernel widths from the distance to the
    ``width_neighbors``-th nearest center of the same region, measured in
    the ``input_scale`` metric.

    ``probs`` (N,) optionally biases the sampling (e.g. ``tube_weights``).

    The draws are numpy's, from ``np.random.default_rng(seed)`` in a fixed
    order (per region: ``choice``, then ``standard_normal`` for the jitter),
    so one table and seed give the same centers as the JAX package, bit for
    bit. With ``x_dev`` (``device_table`` of the same ``x``) the box tests
    and the gather of the chosen rows run on the device; the pool a region
    draws from holds the same rows in the same order either way. Returns
    (centers (R, K, F), log_sigs (R, K)) as tensors of ``x``'s dtype on the
    device."""
    rng = np.random.default_rng(seed)
    resident = x_dev is not None
    dev = x_dev.device if resident else _device_of(x, device)
    np_dtype = (torch.empty(0, dtype=x.dtype).numpy().dtype
                if torch.is_tensor(x) else np.asarray(x[:1]).dtype)
    x_np = None
    if not resident:
        x_np = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    n, F = x.shape
    p_all = None if probs is None else np.asarray(probs, np.float64)
    lb_np = None if lb is None else np.asarray(torch.as_tensor(lb).cpu())
    ub_np = None if ub is None else np.asarray(torch.as_tensor(ub).cpu())
    centers = np.empty((num_regions, num_kernels, F), np_dtype)
    for r in range(num_regions):
        # the pool: row indices into x, or None for every row
        pool_idx, n_pool = None, n
        if lb_np is not None:
            act = [int(d) for d in activation_idx]
            if resident:
                m = _box_mask(x_dev, n, act, lb_np[r] - 1e-9,
                              ub_np[r] + 1e-9)
                found = torch.nonzero(m)[:, 0]
            else:
                xa = x_np[:, act]
                found = np.nonzero(np.all((xa >= lb_np[r] - 1e-9)
                                          & (xa <= ub_np[r] + 1e-9),
                                          axis=1))[0]
            if len(found):
                pool_idx, n_pool = found, len(found)
        p_pool = p_all
        if p_all is not None and pool_idx is not None:
            p_pool = p_all[pool_idx.cpu().numpy() if resident else pool_idx]
        if n_pool < num_kernels:
            idx = rng.choice(n_pool, size=num_kernels, replace=True,
                             p=None if p_pool is None
                             else p_pool / p_pool.sum())
        elif p_pool is None:
            idx = rng.choice(n_pool, size=num_kernels, replace=False)
        else:
            # Gumbel-top-k = weighted sampling WITHOUT replacement in O(N)
            # (numpy's choice(replace=False, p=...) renormalises per draw)
            g = np.log(np.maximum(p_pool, 1e-300)) + rng.gumbel(size=n_pool)
            idx = np.argpartition(g, n_pool - num_kernels)[-num_kernels:]
        if resident:
            rows = torch.as_tensor(idx, device=dev)
            if pool_idx is not None:
                rows = pool_idx[rows]
            picked = x_dev[rows].cpu().numpy().astype(np_dtype)
        else:
            picked = x_np[idx if pool_idx is None else pool_idx[idx]]
        centers[r] = picked + jitter * rng.standard_normal((num_kernels, F))
    log_sigs = widths_from_centers(centers, input_scale=input_scale,
                                   width_neighbors=width_neighbors,
                                   width_factor=width_factor)
    return (torch.as_tensor(centers).to(dev),
            torch.as_tensor(log_sigs.astype(np_dtype)).to(dev))


def widths_from_centers(centers, input_scale=None, width_neighbors: int = 4,
                        width_factor: float = 2.0) -> np.ndarray:
    """Nearest-neighbor RBF widths for GIVEN (R, K, F) centers, the recipe
    ``choose_centers`` applies to sampled ones; also for externally supplied
    center banks (e.g. constraint-cluster warm starts)."""
    centers = np.asarray(centers)
    R, K, F = centers.shape
    s = np.ones(F) if input_scale is None else np.asarray(input_scale)
    log_sigs = np.zeros((R, K))
    for r in range(R):
        cs = centers[r] * s
        d = np.linalg.norm(cs[:, None] - cs[None], axis=-1)
        d.sort(axis=1)
        k = min(width_neighbors, d.shape[1] - 1)
        log_sigs[r] = np.log(np.maximum(width_factor * d[:, k], 1e-6))
    return log_sigs
