"""Truncated symmetric eigensolvers (the SVD engine): the port of
isle_tpu.linalg's thick-restart block Krylov-Schur solver in both its
loops, block_ks_device (the default: the restart loop and its Ritz step
on the device, isle_tpu/linalg.py:276-397) and block_ks (the
host-driven loop, :116-251), of lanczos_device, the single-vector
thick-restart Lanczos kept beside them as an independent cross-check
(:400-559), and of the dense oracle.

Same shapes as the reference: block width `blk` (auto-shrunk for small
dimensions), keep = round_up(nev, blk) Ritz pairs at restart, K = keep +
s*blk square Krylov columns, ncv = K + blk basis columns; the same 2x DGKS
re-orthogonalisation plus one post-QR pass absorbed into R; the same
per-eigenpair relative-residual criterion with zero-mode handling. The two
block loops share their expand step and truncate. All products are
float32 (the package turns TF32 off).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

# Ritz values below RANK_TOL * lambda_max are zero modes of the PSD Gram
# operator; they converge on an absolute test (isle_tpu/linalg.py:40-50).
RANK_TOL = 1e-6


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _init_block(R: torch.Tensor, start: Optional[torch.Tensor]):
    """Orthonormal start block from the random (dim, blk) block R, with the
    caller's previous eigenbasis in the leading columns when given."""
    if start is not None:
        m = min(start.shape[1], R.shape[1])
        R = torch.cat([start[:, :m].to(R), R[:, m:]], dim=1)
    return torch.linalg.qr(R).Q


def _converged_mask(w_nev: torch.Tensor, resid_norms: torch.Tensor,
                    tol: float):
    """Per-eigenpair convergence with zero-mode handling.
    Returns (conv bool[nev], is_zero bool[nev]). The clamps take Python
    floats: no tensor is made on the device from the host."""
    w_max = torch.clamp(torch.abs(w_nev[0]), min=1e-30)
    is_zero = torch.abs(w_nev) <= RANK_TOL * w_max
    rel = resid_norms / torch.clamp(torch.abs(w_nev), min=1e-30)
    conv = torch.where(is_zero, resid_norms <= tol * w_max, rel < tol)
    return conv, is_zero


@dataclasses.dataclass
class EigResult:
    evals: np.ndarray  # (nev,) descending
    evecs: torch.Tensor  # (dim, nev)
    nconv: int
    restarts: int
    op_calls: int
    op_seconds: float


def _dgks_project(V: torch.Tensor, F: torch.Tensor, rounds: int = 2):
    """F <- (I - V V^T) F applied rounds+1 times; returns (F, V^T F summed
    over the passes). Inactive columns of V are zero."""
    C = V.T @ F
    F = F - V @ C
    for _ in range(rounds):
        C2 = V.T @ F
        F = F - V @ C2
        C = C + C2
    return F, C


def _qr_ortho(V: torch.Tensor, F: torch.Tensor):
    """QR of F with one extra DGKS pass against V absorbed into R."""
    Q1, R1 = torch.linalg.qr(F)
    C2 = V.T @ Q1
    Q1 = Q1 - V @ C2
    Q2, R2 = torch.linalg.qr(Q1)
    return Q2, R2 @ R1, C2 @ R1


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _krylov_shapes(dim: int, nev: int, blk: int,
                   steps_per_restart: Optional[int]):
    """(blk, keep, s, K, ncv) of both block loops: the block auto-shrunk
    so that the Krylov space fits the operator dimension (small
    vocabularies; nev too close to dim takes the dense oracle)."""
    blk = min(blk, max(dim // 2, 1))
    while True:
        keep = _round_up(nev, blk)
        s = steps_per_restart or max(1, keep // blk)
        K = keep + s * blk
        ncv = K + blk
        if ncv <= dim or blk == 1:
            break
        blk = max(blk // 2, 1)
    if ncv > dim:
        raise ValueError(
            f"ncv={ncv} exceeds dim={dim} even at blk=1; use the dense "
            f"eigensolver (nev={nev})"
        )
    return blk, keep, s, K, ncv


def _start_basis(dim: int, ncv: int, K: int, blk: int, draws, device,
                 start_block: Optional[torch.Tensor]):
    """The zero basis V (dim, ncv) with the orthonormal start block in its
    first blk columns, and the zero projected matrix H (ncv, K)."""
    V = torch.zeros((dim, ncv), dtype=torch.float32, device=device)
    H = torch.zeros((ncv, K), dtype=torch.float32, device=device)
    R0 = draws.krylov_start(dim, blk).to(device)
    V[:, :blk] = _init_block(R0, start_block)
    return V, H


def _expand(op, V: torch.Tensor, H: torch.Tensor, m: int, blk: int) -> None:
    """One block step in place: op on V's columns [m, m + blk),
    orthogonalized against the basis, its coefficients into H's columns
    [m, m + blk) with R below them, its Q into V's next block."""
    F = op(V[:, m:m + blk])
    F, Hk = _dgks_project(V, F, rounds=2)
    Q, R, Cfix = _qr_ortho(V, F)
    Hk = Hk + Cfix
    Hk[m + blk:m + 2 * blk] = R
    H[:, m:m + blk] = Hk
    V[:, m + blk:m + 2 * blk] = Q


def _ritz(H: torch.Tensor, K: int, on_host: bool):
    """Eigenpairs (w, W) of the symmetrised K x K projected matrix, in a
    stable descending order, float32 on H's device. on_host: LAPACK's
    float32 eigh on the host (block_ks); else a float64 eigh on H's own
    device (block_ks_device): the card's float32 eigh moved every
    eigenvalue by ~1.7e-4 relative at K = 256 on an H100."""
    Hs = H[:K, :K]
    if on_host:
        Hs = Hs.cpu()
    else:
        Hs = Hs.to(torch.float64)
    w, W = torch.linalg.eigh((Hs + Hs.T) * 0.5)
    order = torch.argsort(-w, stable=True)
    return (w[order].to(H.device, torch.float32),
            W[:, order].to(H.device, torch.float32))


def _truncate(V: torch.Tensor, H: torch.Tensor, w: torch.Tensor,
              W: torch.Tensor, nev: int, keep: int, tol: float):
    """Thick restart (no locking): the Ritz pairs' residual norms and
    convergence, and the new basis, the kept Ritz vectors rotated to the
    front and the last block after them. Returns (V, H, residual norms,
    conv, is_zero), all on V's device."""
    K = W.shape[0]
    ncv = V.shape[1]
    blk = ncv - K
    resid = H[K:ncv, :K] @ W  # (blk, K)
    rnorm = torch.linalg.norm(resid[:, :nev], dim=0)
    conv, is_zero = _converged_mask(w[:nev], rnorm, tol)
    Vnew = torch.zeros_like(V)
    Vnew[:, :keep] = V[:, :K] @ W[:, :keep]
    Vnew[:, keep:keep + blk] = V[:, K:ncv]
    Hnew = torch.zeros_like(H)
    Hnew[:keep, :keep] = torch.diag(w[:keep])
    Hnew[keep:keep + blk, :keep] = resid[:, :keep]
    return Vnew, Hnew, rnorm, conv, is_zero


def block_ks(
    op: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    nev: int,
    draws,
    device,
    blk: int = 128,
    tol: float = 1e-4,
    max_restarts: int = 100,
    steps_per_restart: Optional[int] = None,
    timer=None,
    start_block: Optional[torch.Tensor] = None,
) -> EigResult:
    """Top-`nev` eigenpairs of the symmetric PSD operator `op` on R^dim;
    op maps (dim, blk) -> (dim, blk) float32 tensors on `device`. The
    random start block comes from draws.krylov_start(dim, blk).

    The host-driven loop (GpuConfig.device_loop_solver=False): each
    restart solves its Ritz problem with LAPACK on the host, reads the
    convergence back and logs a diagnostic line."""
    blk, keep, s, K, ncv = _krylov_shapes(dim, nev, blk, steps_per_restart)
    V, H = _start_basis(dim, ncv, K, blk, draws, device, start_block)

    op_calls = 0
    op_seconds = 0.0
    m = 0  # active square columns of H
    restarts = 0
    while True:
        t0 = time.perf_counter()
        steps = (K - m) // blk
        for i in range(steps):
            _expand(op, V, H, m + i * blk, blk)
        if steps:
            _sync(V)
            op_seconds += time.perf_counter() - t0
            op_calls += steps
        w, W = _ritz(H, K, on_host=True)
        V, H, rnorm, conv, is_zero = _truncate(V, H, w, W, nev, keep, tol)
        conv_h = conv.cpu().numpy()
        is_zero_h = is_zero.cpu().numpy()
        norms_h = (rnorm / torch.clamp(torch.abs(w[:nev]), min=1e-30)).cpu()
        bad = np.flatnonzero(~conv_h)
        nconv = int(bad[0]) if len(bad) else nev
        evals = np.where(is_zero_h, 0.0, w[:nev].cpu().numpy()).astype(
            np.float32
        )
        if timer is not None:
            timer.diag(
                f"block_ks restart {restarts}: nconv={nconv}/{nev} "
                f"max_resid={float(norms_h.max()):.2e}"
            )
        m = keep
        if nconv >= nev or restarts >= max_restarts:
            break
        restarts += 1

    return EigResult(
        evals=evals,
        evecs=V[:, :nev],
        nconv=nconv,
        restarts=restarts,
        op_calls=op_calls,
        op_seconds=op_seconds,
    )


def block_ks_device(
    op: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    nev: int,
    draws,
    device,
    blk: int = 128,
    tol: float = 1e-4,
    max_restarts: int = 100,
    steps_per_restart: Optional[int] = None,
    timer=None,
    start_block: Optional[torch.Tensor] = None,
) -> EigResult:
    """block_ks with its restart loop on the device, the default solver
    (GpuConfig.device_loop_solver; isle_tpu/linalg.py:276-397): the same
    shapes, start block, expand step and truncate, but each Ritz problem
    is solved in float64 on the tensors' own device and the convergence
    mask, the count of converged pairs (the first unconverged index) and
    the eigenvalues, zero modes set to 0, stay there. A restart waits on
    the host only for that count, read back for the stop test, and for
    torch.linalg.eigh's own check of its result (on CUDA it
    synchronizes; a failed eigh raises). K/blk expand steps and a
    truncate, then restarts of s steps and a truncate while
    nconv < nev and restarts < max_restarts. One diagnostic line for the
    solve; op_calls = K/blk + s * restarts, op_seconds the whole solve."""
    blk, keep, s, K, ncv = _krylov_shapes(dim, nev, blk, steps_per_restart)
    t0 = time.perf_counter()
    V, H = _start_basis(dim, ncv, K, blk, draws, device, start_block)

    def restart(V, H, m):
        for i in range(m, K, blk):
            _expand(op, V, H, i, blk)
        w, W = _ritz(H, K, on_host=False)
        V, H, _, conv, is_zero = _truncate(V, H, w, W, nev, keep, tol)
        # the longest converged prefix: an integer scan
        nconv = torch.cumprod(conv.to(torch.int32), 0).sum()
        return V, H, nconv, torch.where(is_zero, 0.0, w[:nev])

    V, H, nconv_d, evals_d = restart(V, H, 0)
    nconv = int(nconv_d)  # the stop test's readback
    restarts = 0
    while nconv < nev and restarts < max_restarts:
        V, H, nconv_d, evals_d = restart(V, H, keep)
        nconv = int(nconv_d)
        restarts += 1
    evals = evals_d.cpu().numpy()
    _sync(V)
    seconds = time.perf_counter() - t0
    if timer is not None:
        timer.diag(
            f"block_ks_device: {restarts} restarts, nconv={nconv}/{nev}, "
            f"{seconds:.2f}s"
        )
    return EigResult(
        evals=evals,
        evecs=V[:, :nev],
        nconv=nconv,
        restarts=restarts,
        op_calls=K // blk + s * restarts,
        op_seconds=seconds,
    )


def lanczos(
    op: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    nev: int,
    draws,
    device,
    tol: float = 1e-4,
    max_restarts: int = 100,
    steps_per_restart: Optional[int] = None,
    start_vector: Optional[torch.Tensor] = None,
    timer=None,
) -> EigResult:
    """Top-`nev` eigenpairs of the symmetric PSD operator `op` by
    single-vector thick-restart Lanczos: a three-term recurrence with two
    full reorthogonalization passes a step, width-1 operator calls (op
    maps (dim, 1) -> (dim, 1)), a K x K projected matrix with K = nev + s
    (s = steps_per_restart or nev + 8), and the Wu-Simon restart keeping
    the top nev Ritz pairs plus the border row. Convergence is block_ks's
    rule on the border residuals, so the two solvers compare at one tol.

    Host-driven: the steps of a restart are enqueued without a
    synchronize; the host waits once a restart, for the projected matrix,
    whose eigenproblem LAPACK solves (see block_ks). Its width-1 SpMMs
    run on the gather kernel's narrow form (segsum.NARROW_MAX_WIDTH),
    lanes across entries.

    The start vector comes from draws.lanczos_start(dim) unless
    `start_vector` is given and nonzero. When the residual of a step falls
    to the float32 noise floor of its projected column (b <= 1e-6 *
    max(|coeffs|, 1)), normalizing it would put rounding noise into the
    basis: the step continues with draws.lanczos_refill(j, dim),
    orthogonalized twice against the basis, and a beta of exactly 0. A
    step only flags its breakdown on the device; the flags come to the
    host with the projected matrix, and the steps behind a flagged one are
    taken again after its refill (op_calls counts each step once)."""
    s = steps_per_restart or (nev + 8)
    K = nev + s
    ncv = K + 1
    if ncv > dim:
        raise ValueError(f"ncv={ncv} exceeds dim={dim}; use dense solver")
    tiny = torch.finfo(torch.float32).tiny

    def unit(x):
        return x / torch.clamp(torch.linalg.norm(x), min=1e-30)

    def step(V, T, j):
        w = op(V[:, j:j + 1])[:, 0]
        c1 = V.T @ w
        w = w - V @ c1
        c2 = V.T @ w
        w = w - V @ c2
        coeffs = c1 + c2  # alpha at j, the restart's fill-ins above it
        b = torch.linalg.norm(w)
        T[ncv, j] = b <= 1e-6 * torch.clamp(coeffs.abs().max(), min=1.0)
        V[:, j + 1] = w / torch.clamp(b, min=tiny)
        coeffs[j + 1] = b
        T[:ncv, j] = coeffs

    def refill(V, T, j):
        V[:, j + 1:] = 0.0  # what the steps behind j left
        rnd = draws.lanczos_refill(j, dim).to(device)
        for _ in range(2):
            rnd = rnd - V @ (V.T @ rnd)
        V[:, j + 1] = unit(rnd)
        T[j + 1, j] = 0.0
        T[ncv, j] = 0.0

    def sweep(V, T, j):
        """Steps j..K-1; returns T on the host (rows :ncv the projected
        matrix, row ncv the breakdown flags, all clear)."""
        while True:
            for i in range(j, K):
                step(V, T, i)
            host = T.cpu()  # the restart's one synchronize
            broke = np.flatnonzero(host[ncv, j:].numpy())
            if broke.size == 0:
                return host
            j += int(broke[0])
            refill(V, T, j)
            j += 1

    def truncate(V, T, host):
        Ts = host[:K, :K]
        Ts = (Ts + Ts.T) * 0.5
        w, W = torch.linalg.eigh(Ts)
        order = torch.argsort(-w, stable=True)
        w = w[order].to(device)
        W = W[:, order].to(device)
        resid = T[K:ncv, :K] @ W  # (1, K) border row
        conv, is_zero = _converged_mask(w[:nev], resid[0, :nev].abs(), tol)
        bad = np.flatnonzero(~conv.cpu().numpy())
        nconv = int(bad[0]) if len(bad) else nev
        Vn = torch.zeros_like(V)
        Vn[:, :nev] = V[:, :K] @ W[:, :nev]
        Vn[:, nev] = V[:, K]  # the residual Lanczos vector
        Tn = torch.zeros_like(T)
        Tn[:nev, :nev] = torch.diag(w[:nev])
        Tn[nev, :nev] = resid[0, :nev]
        evals = torch.where(is_zero, 0.0, w[:nev]).cpu().numpy()
        return Vn, Tn, evals.astype(np.float32), nconv

    t0 = time.perf_counter()
    v0 = None
    if start_vector is not None:
        v0 = start_vector.to(device=device, dtype=torch.float32)
        if not bool(torch.linalg.norm(v0) > 0.0):
            v0 = None
    if v0 is None:
        v0 = draws.lanczos_start(dim).to(device)
    V = torch.zeros((dim, ncv), dtype=torch.float32, device=device)
    # the projected matrix, and one more row for the breakdown flags
    T = torch.zeros((ncv + 1, K), dtype=torch.float32, device=device)
    V[:, 0] = unit(v0)
    V, T, evals, nconv = truncate(V, T, sweep(V, T, 0))
    restarts = 0
    while nconv < nev and restarts < max_restarts:
        V, T, evals, nconv = truncate(V, T, sweep(V, T, nev))
        restarts += 1
    _sync(V)
    seconds = time.perf_counter() - t0
    if timer is not None:
        timer.diag(f"lanczos: {restarts} restarts, nconv={nconv}/{nev}, "
                   f"{seconds:.2f}s")
    return EigResult(
        evals=evals,
        evecs=V[:, :nev],
        nconv=nconv,
        restarts=restarts,
        op_calls=K + s * restarts,
        op_seconds=seconds,
    )


def dense_topk_eigh(S: np.ndarray, nev: int) -> Tuple[np.ndarray, np.ndarray]:
    """Dense oracle (float64 eigh, eigenvalues descending)."""
    w, v = np.linalg.eigh(S.astype(np.float64))
    order = np.argsort(-w)
    return w[order][:nev], v[:, order][:, :nev]


def align_signs(U: np.ndarray, U_ref: np.ndarray) -> np.ndarray:
    """Flip eigenvector signs to match a reference."""
    s = np.sign(np.sum(U * U_ref, axis=0))
    s[s == 0] = 1.0
    return U * s
