"""HyperLogLog cardinality estimators (Ertl family), vectorized.

The reference exposes four estimation modes, selected by -E/-I/-m/-J
(reference src/distmain.cpp:59-62, src/dashing.cpp:298-314):

  ORIGINAL        Flajolet et al.'s estimator with range corrections
  ERTL_IMPROVED   Ertl's improved raw estimator (sigma/tau corrections)
  ERTL_MLE        Poisson-model maximum-likelihood estimate   [default]
  ERTL_JOINT_MLE  joint MLE over register PAIRS -> (|A\\B|, |B\\A|, |A&B|)

The math follows Ertl, "New Cardinality Estimation Methods for HyperLogLog
Sketches" (arXiv:1706.07290).  Unlike the reference's scalar secant loops,
the MLE and joint MLE here are fixed-iteration damped Newton solvers on the
exact Poisson log-likelihood, written so that a single jit/vmap evaluates
thousands of pairs in parallel.

Everything consumes REGISTER HISTOGRAMS, not registers: C[k] = #registers
with value k, k = 0..q+1 (q = 64 - p).  Histograms are tiny (<= 64 bins), so
the estimator cost is independent of sketch size; the expensive histogram
construction is a batch of int8 matmuls (see ops/pairwise.py).

Joint-MLE likelihood derivation (documented here because it differs from the
reference's implementation strategy while estimating the same model):
under Ertl's Poisson model with unknowns (la, lb, lx) = cardinalities of
A-only, B-only, A&B, register pairs (K_A, K_B) have CDF
    F(a, b) = exp(-(la*z_a + lb*z_b + lx*z_min(a,b)) / m),   z_k = 2^-k
(z_{q+1} = 0).  The pmf by 2-D finite differencing factorizes off-diagonal:
    b < a:  P(a,b) = f(a; la) * f(b; lb+lx)
    a < b:  P(a,b) = f(b; lb) * f(a; la+lx)
where f(k; l) is the single-sketch register pmf, and on the diagonal
    P(k,k) = e1(z_k) - g_a(k) - g_b(k) + e1(z_{k-1}),
    e1(z)  = exp(-(la+lb+lx) z / m)
    g_a(k) = exp(-((la+lx) z_{k-1} + lb z_k) / m)   (and g_b symmetric).
Hence the sufficient statistics are five small histograms: c_gt_a, c_lt_a,
c_gt_b, c_lt_b, c_eq (same ones Ertl's Algorithm 9 builds).
"""
from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Estimation-method codes, numerically matching the reference CLI semantics.
ORIGINAL = 0
ERTL_IMPROVED = 1
ERTL_MLE = 2
ERTL_JOINT_MLE = 3

_ALPHA_INF = 1.0 / (2.0 * math.log(2.0))


# ---------------------------------------------------------------------------
# Histograms
# ---------------------------------------------------------------------------

def register_histogram(regs: jnp.ndarray, q: int) -> jnp.ndarray:
    """Histogram of register values along the last axis -> (..., q+2) f32.

    Built as a one-hot contraction so batched calls become a single matmul.
    """
    levels = jnp.arange(q + 2, dtype=regs.dtype)
    onehot = (regs[..., :, None] == levels).astype(jnp.float32)
    return onehot.sum(axis=-2)


# ---------------------------------------------------------------------------
# sigma / tau (Ertl eq. 29-30) — used by the improved estimator.
# ---------------------------------------------------------------------------

def _sigma(x, iters: int = 64):
    """sigma(x) = x + sum_{k>=1} x^(2^k) * 2^(k-1); sigma(1) = +inf."""
    def body(_, st):
        xx, y, z = st
        xx2 = xx * xx
        return xx2, y * 2.0, z + xx2 * y
    x0 = x
    _, _, z = jax.lax.fori_loop(0, iters, body, (x0, jnp.ones_like(x), x0))
    return jnp.where(x >= 1.0, jnp.inf, z)


def _tau(x, iters: int = 64):
    """tau(x) = (1/3)(1 - x - sum_{k>=1} (1 - x^(2^-k))^2 * 2^-k)."""
    def body(_, st):
        xx, y, z = st
        xx = jnp.sqrt(xx)
        y = y * 0.5
        z = z - (1.0 - xx) ** 2 * y
        return xx, y, z
    _, _, z = jax.lax.fori_loop(0, iters, body, (x, jnp.ones_like(x), 1.0 - x))
    z = z / 3.0
    return jnp.where((x <= 0.0) | (x >= 1.0), 0.0, z)


# ---------------------------------------------------------------------------
# Single-sketch estimators.  All take C: (..., q+2) float32 histogram.
# ---------------------------------------------------------------------------

def original_estimate(C: jnp.ndarray, p: int) -> jnp.ndarray:
    """Flajolet's classic estimator with the small-range correction."""
    m = float(1 << p)
    q = C.shape[-1] - 2
    k = jnp.arange(q + 2, dtype=jnp.float32)
    denom = (C * jnp.exp2(-k)).sum(-1)
    if m >= 128:
        alpha = 0.7213 / (1.0 + 1.079 / m)
    else:
        alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(int(m), 0.7213 / (1.0 + 1.079 / m))
    e = alpha * m * m / denom
    c0 = C[..., 0]
    small = (e <= 2.5 * m) & (c0 > 0)
    e_small = m * jnp.log(m / jnp.maximum(c0, 1e-9))
    return jnp.where(small, e_small, e)


def improved_estimate(C: jnp.ndarray, p: int) -> jnp.ndarray:
    """Ertl's improved raw estimator (arXiv:1706.07290 eq. 28).

    sigma's series term is x^(2^k)*2^(k-1) with x <= 1 - 1/m, so by
    k = p + 6 the term is below exp(-64)*2^k — float32 converged; tau's
    terms shrink ~8x per iteration once k > log2(-ln x), so 24 covers any
    p.  (These loops are the dominant cost of the n^2-pair estimator init,
    so the iteration counts matter.)
    """
    m = float(1 << p)
    q = C.shape[-1] - 2
    k = jnp.arange(1, q + 1, dtype=jnp.float32)
    mid = (C[..., 1:q + 1] * jnp.exp2(-k)).sum(-1)
    denom = (m * _sigma(C[..., 0] / m, iters=p + 6)
             + mid
             + m * _tau(1.0 - C[..., q + 1] / m, iters=24) * (2.0 ** -q))
    return _ALPHA_INF * m * m / denom


def _mle_dlogl12(x, C, q):
    """(L'(x), L''(x)) of the Poisson log-likelihood, one fused pass.

    L'  = -C0 + sum_k C_k z_k (1/(e^{x z_k}-1) - 1) + C_{q+1} z_q/(e^{x z_q}-1)
    L'' =       sum_k C_k z_k^2 d_k               + C_{q+1} z_q^2 d_q,
        d = -e^a/(e^a-1)^2 = -(1/em + 1/em^2) with em = expm1(a).
    """
    k = jnp.arange(1, q + 1, dtype=jnp.float32)
    zk = jnp.exp2(-k)
    a = jnp.maximum(x[..., None] * zk, 1e-30)
    # w = z/expm1(x z) <= 1/x stays f32-finite even when z*inv alone would
    # not (inv^2 overflows f32 for a < ~1e-19); always form z*inv first.
    w = zk / jnp.expm1(a)
    mid1 = (C[..., 1:q + 1] * (w - zk)).sum(-1)
    mid2 = (C[..., 1:q + 1] * (-(w * w + zk * w))).sum(-1)
    zq = 2.0 ** -q
    aq = jnp.maximum(x * zq, 1e-30)
    wq = zq / jnp.expm1(aq)
    top1 = C[..., q + 1] * wq
    top2 = C[..., q + 1] * (-(wq * wq + zq * wq))
    return -C[..., 0] + mid1 + top1, mid2 + top2


def mle_estimate(C: jnp.ndarray, p: int, iters: int = 24) -> jnp.ndarray:
    """Poisson MLE (the reference's default ERTL_MLE), by damped Newton on
    u = log(x) with the analytic Hessian.  Initialized from the improved
    estimator.  The log-likelihood in u is smooth and unimodal; 24 damped
    steps reach float32 fixed point from the improved-estimator init
    (validated against the float64 bisection oracle in tests)."""
    m = float(1 << p)
    q = C.shape[-1] - 2
    mtot = C.sum(-1)
    empty = C[..., 0] >= mtot          # all registers zero -> 0
    full = C[..., q + 1] >= mtot       # all saturated -> inf

    x0 = jnp.clip(improved_estimate(C, p) / m, 1e-12, 2.0 ** (q + 1))
    u0 = jnp.log(x0)

    def body(_, u):
        x = jnp.exp(u)
        g, gp = _mle_dlogl12(x, C, q)
        # chain rule into u = log x: dL/du = x g ; d2L/du2 = x g + x^2 g'
        dldu = x * g
        d2 = dldu + x * x * gp
        step = dldu / jnp.minimum(d2, -1e-9)
        step = jnp.clip(step, -1.0, 1.0)
        return u - step

    u = jax.lax.fori_loop(0, iters, body, u0)
    est = jnp.exp(u) * m
    # full first, empty LAST: a zero-mass histogram satisfies both
    # masks and must return 0 like the f64 oracle, not inf
    est = jnp.where(full, jnp.inf, est)
    return jnp.where(empty, 0.0, est)


@partial(jax.jit, static_argnames=("p", "method"))
def estimate(C: jnp.ndarray, p: int, method: int = ERTL_MLE) -> jnp.ndarray:
    # jitted: called OUTSIDE jit (HLL.report, cardinality emission) this
    # would otherwise run eagerly, one device dispatch per op.  Nested use
    # inside other jits inlines.
    if method == ORIGINAL:
        return original_estimate(C, p)
    if method == ERTL_IMPROVED:
        return improved_estimate(C, p)
    return mle_estimate(C, p)


# ---------------------------------------------------------------------------
# Level-windowed estimators: registers cluster in ~a dozen consecutive
# levels, so the all-pairs engine (ops/pairwise.py) resolves only levels
# [kmin, kmax].  Estimating directly on the windowed histogram (exact when
# every register lies inside the window) skips both the zero-bin compute
# and — when the window excludes levels 0 and q+1 — the sigma/tau series
# entirely, which dominated the n^2-pair estimator cost.
# ---------------------------------------------------------------------------

def _win_parts(Cw: jnp.ndarray, p: int, kmin: int):
    """Split a windowed histogram into (C0, Cmid, Ctop, mid levels, axis)."""
    q = 64 - p
    K = Cw.shape[-1]
    kmax = kmin + K - 1
    lo = max(kmin, 1)
    hi = min(kmax, q)
    c0 = Cw[..., 0] if kmin == 0 else jnp.zeros(Cw.shape[:-1], Cw.dtype)
    ctop = (Cw[..., -1] if kmax == q + 1
            else jnp.zeros(Cw.shape[:-1], Cw.dtype))
    sl = slice(lo - kmin, hi - kmin + 1)
    k = jnp.arange(lo, hi + 1, dtype=jnp.float32)
    return c0, Cw[..., sl], ctop, k, -1


def improved_estimate_windowed(Cw: jnp.ndarray, p: int, kmin: int
                               ) -> jnp.ndarray:
    m = float(1 << p)
    q = 64 - p
    K = Cw.shape[-1]
    c0, cmid, ctop, k, ax = _win_parts(Cw, p, kmin)
    mid = (cmid * jnp.exp2(-k)).sum(ax)
    denom = mid
    if kmin == 0:
        denom = denom + m * _sigma(c0 / m, iters=p + 6)
    if kmin + K - 1 == q + 1:
        denom = denom + m * _tau(1.0 - ctop / m, iters=24) * (2.0 ** -q)
    return _ALPHA_INF * m * m / denom


def _mle_dlogl12_windowed(x, c0, cmid, ctop, k, q: int, ax: int = -1):
    zk = jnp.exp2(-k)
    a = jnp.maximum(x[..., None] * zk, 1e-30)
    w = zk / jnp.expm1(a)
    d1 = (cmid * (w - zk)).sum(ax) - c0
    d2 = (cmid * (-(w * w + zk * w))).sum(ax)
    zq = 2.0 ** -q
    aq = jnp.maximum(x * zq, 1e-30)
    wq = zq / jnp.expm1(aq)
    return d1 + ctop * wq, d2 + ctop * (-(wq * wq + zq * wq))


def mle_estimate_windowed(Cw: jnp.ndarray, p: int, kmin: int,
                          iters: int = 12) -> jnp.ndarray:
    """MLE on a level-windowed histogram (levels kmin..kmin+K-1).

    Exact when every register lies inside the window — the all-pairs engine
    guarantees this by setting kmin/kmax from the stacked registers.
    12 iterations: the improved-estimator init is within ~2x of the optimum
    (<1 in log space) and each damped Newton step is superlinear once near
    it; measured f32 fixpoint by iteration 8 across 10..2e6 cardinalities."""
    m = float(1 << p)
    q = 64 - p
    c0, cmid, ctop, k, ax = _win_parts(Cw, p, kmin)
    mtot = Cw.sum(-1)
    empty = c0 >= mtot
    full = ctop >= mtot

    x0 = jnp.clip(improved_estimate_windowed(Cw, p, kmin) / m,
                  1e-12, 2.0 ** (q + 1))
    u0 = jnp.log(x0)

    def body(_, u):
        x = jnp.exp(u)
        g, gp = _mle_dlogl12_windowed(x, c0, cmid, ctop, k, q, ax)
        dldu = x * g
        d2 = dldu + x * x * gp
        step = dldu / jnp.minimum(d2, -1e-9)
        return u - jnp.clip(step, -1.0, 1.0)

    u = jax.lax.fori_loop(0, iters, body, u0)
    est = jnp.exp(u) * m
    # full first, empty LAST: a zero-mass histogram satisfies both
    # masks and must return 0 like the f64 oracle, not inf
    est = jnp.where(full, jnp.inf, est)
    return jnp.where(empty, 0.0, est)


def original_estimate_windowed(Cw: jnp.ndarray, p: int, kmin: int
                               ) -> jnp.ndarray:
    m = float(1 << p)
    K = Cw.shape[-1]
    k = jnp.arange(kmin, kmin + K, dtype=jnp.float32)
    denom = (Cw * jnp.exp2(-k)).sum(-1)
    c0 = Cw[..., 0] if kmin == 0 else jnp.zeros(Cw.shape[:-1], Cw.dtype)
    alpha = (0.7213 / (1.0 + 1.079 / m) if m >= 128
             else {16: 0.673, 32: 0.697, 64: 0.709}.get(
                 int(m), 0.7213 / (1.0 + 1.079 / m)))
    e = alpha * m * m / denom
    small = (e <= 2.5 * m) & (c0 > 0)
    e_small = m * jnp.log(m / jnp.maximum(c0, 1e-9))
    return jnp.where(small, e_small, e)


@partial(jax.jit, static_argnames=("p", "kmin", "method"))
def estimate_windowed(Cw: jnp.ndarray, p: int, kmin: int,
                      method: int = ERTL_MLE) -> jnp.ndarray:
    if method == ORIGINAL:
        return original_estimate_windowed(Cw, p, kmin)
    if method == ERTL_IMPROVED:
        return improved_estimate_windowed(Cw, p, kmin)
    return mle_estimate_windowed(Cw, p, kmin)


# ---------------------------------------------------------------------------
# Joint MLE over register pairs.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("q",))
def pair_statistics(a: jnp.ndarray, b: jnp.ndarray, q: int):
    """Sufficient statistics for one register pair (each (..., m) int).

    Returns dict of (..., q+2) float32 histograms: gt_a, lt_a, gt_b, lt_b, eq,
    plus the marginal histograms and the union (max) histogram.
    """
    levels = jnp.arange(q + 2, dtype=a.dtype)
    oa = (a[..., :, None] == levels)
    ob = (b[..., :, None] == levels)
    agtb = (a > b)[..., None]
    altb = (a < b)[..., None]
    aeqb = (a == b)[..., None]
    f32 = jnp.float32
    return dict(
        gt_a=(oa & agtb).astype(f32).sum(-2),
        lt_a=(oa & altb).astype(f32).sum(-2),
        gt_b=(ob & altb).astype(f32).sum(-2),
        lt_b=(ob & agtb).astype(f32).sum(-2),
        eq=(oa & aeqb).astype(f32).sum(-2),
        hist_a=oa.astype(f32).sum(-2),
        hist_b=ob.astype(f32).sum(-2),
        hist_u=((jnp.maximum(a, b))[..., :, None] == levels).astype(f32).sum(-2),
    )


def _k_parts(h, kmin: int, q: int):
    """Split a K-last level-stacked array (the vmap-over-scalar-pairs
    layout).  Returns (mid-slice, bin0, top-bin, mid-level constants,
    reduction axis, kmax)."""
    K = h.shape[-1]
    kmax = kmin + K - 1
    lo, hi = max(kmin, 1), min(kmax, q)
    k = jnp.arange(lo, hi + 1, dtype=jnp.float32)
    return (h[..., lo - kmin:hi - kmin + 1], h[..., 0], h[..., -1], k,
            -1, kmax)


def _log_f(k_hist: jnp.ndarray, lam, m: float, q: int, kmin: int = 0):
    """sum_k hist[k] * log f(k; lam): single-register pmf log-likelihood.

    `k_hist` covers levels kmin..kmin+K-1 (kmin=0, K=q+2 is the full
    histogram); the window form feeds the level-windowed joint MLE."""
    x = lam / m
    hm, h0, htop, k, ax, kmax = _k_parts(k_hist, kmin, q)
    a = x[..., None] * jnp.exp2(-k)
    log_mid = -a + jnp.log(-jnp.expm1(-jnp.maximum(a, 1e-38)))
    L = (hm * log_mid).sum(ax)
    if kmin == 0:
        L = L + h0 * (-x)
    if kmax == q + 1:
        aq = x * (2.0 ** -q)
        L = L + htop * jnp.log(-jnp.expm1(-jnp.maximum(aq, 1e-38)))
    return L


def _lvl_consts(stats, kmin: int):
    """(kk, reduction axis) level constants for the diagonal term."""
    K = stats["eq"].shape[-1]
    return jnp.arange(kmin, kmin + K, dtype=jnp.float32), -1


def _joint_logl(theta, stats, m: float, q: int, kmin: int = 0):
    """Joint Poisson log-likelihood at theta = (log la, log lb, log lx)."""
    la, lb, lx = jnp.exp(theta[0]), jnp.exp(theta[1]), jnp.exp(theta[2])
    L = _log_f(stats["gt_a"], la, m, q, kmin)
    L += _log_f(stats["lt_b"], lb + lx, m, q, kmin)
    L += _log_f(stats["gt_b"], lb, m, q, kmin)
    L += _log_f(stats["lt_a"], la + lx, m, q, kmin)
    # diagonal terms
    kk, ax = _lvl_consts(stats, kmin)
    zk = jnp.where(kk <= q, jnp.exp2(-kk), 0.0)           # z_k, z_{q+1}=0
    zk1 = jnp.where(kk >= 1, jnp.exp2(-(kk - 1.0)), jnp.inf)  # z_{k-1}, z_-1=inf
    labx = la + lb + lx
    e_kk = jnp.exp(-labx * zk / m)
    e_k1 = jnp.where(jnp.isinf(zk1), 0.0, jnp.exp(-labx * zk1 / m))
    g_a = jnp.where(jnp.isinf(zk1), 0.0,
                    jnp.exp(-((la + lx) * zk1 + lb * zk) / m))
    g_b = jnp.where(jnp.isinf(zk1), 0.0,
                    jnp.exp(-((lb + lx) * zk1 + la * zk) / m))
    # clamp at a NORMAL f32 (1e-38 is subnormal and flushes to 0 on XLA,
    # making log() -inf), and zero unobserved bins explicitly: 0 * -inf = nan
    p_eq = jnp.maximum(e_kk - g_a - g_b + e_k1, 1e-30)
    w = stats["eq"]
    L += jnp.where(w > 0, w * jnp.log(p_eq), 0.0).sum(ax)
    return L


def _f_val_d1_d2(h, lam, m: float, q: int, kmin: int = 0):
    """(value, d/dlam, d2/dlam2) of sum_k h[k] log f(k; lam), sharing the
    expm1 evaluations across the three outputs.  Derivatives are w.r.t.
    x = lam/m (the caller applies the 1/m chain factors).  `h` covers
    levels kmin..kmin+K-1 (windowed joint MLE); kmin=0, K=q+2 is full."""
    x = lam / m
    K = h.shape[-1]
    kmax = kmin + K - 1
    lo, hi = max(kmin, 1), min(kmax, q)
    k = jnp.arange(lo, hi + 1, dtype=jnp.float32)
    zk = jnp.exp2(-k)
    a = jnp.maximum(x[..., None] * zk, 1e-30)
    em = jnp.expm1(a)
    w = zk / em                      # z/(e^a - 1), <= 1/x: f32-safe
    hm = h[..., lo - kmin:hi - kmin + 1]
    # log f(k) = -a + log(1 - e^-a); the (log(em) - 2a) form overflows f32
    # for a > ~88, so evaluate 1 - e^-a directly as -expm1(-a)
    val = (hm * (-a + jnp.log(-jnp.expm1(-a)))).sum(-1)
    d1 = (hm * (w - zk)).sum(-1)
    d2 = (hm * (-(w * w + zk * w))).sum(-1)
    if kmin == 0:
        val = val + h[..., 0] * (-x)
        d1 = d1 - h[..., 0]
    if kmax == q + 1:
        zq = 2.0 ** -q
        aq = jnp.maximum(x * zq, 1e-30)
        wq = zq / jnp.expm1(aq)
        htop = h[..., -1]
        val = val + htop * jnp.log(-jnp.expm1(-aq))
        d1 = d1 + htop * wq
        d2 = d2 + htop * (-(wq * wq + zq * wq))
    return val, d1, d2


def _f_d1_d2(h, lam, m: float, q: int, kmin: int = 0):
    """(d/dx, d2/dx2) of sum_k h[k] log f(k; lam) w.r.t. x = lam/m —
    the value-free sibling of _f_val_d1_d2 (K-last layout): the Newton
    loop needs only derivatives, and skipping the value skips ALL log
    evaluations (the most expensive transcendental)."""
    x = lam / m
    hm, h0, htop, k, ax, kmax = _k_parts(h, kmin, q)
    zk = jnp.exp2(-k)
    a = jnp.maximum(x[..., None] * zk, 1e-30)
    w = zk / jnp.expm1(a)
    d1 = (hm * (w - zk)).sum(ax)
    d2 = (hm * (-(w * w + zk * w))).sum(ax)
    if kmin == 0:
        d1 = d1 - h0
    if kmax == q + 1:
        zq = 2.0 ** -q
        aq = jnp.maximum(x * zq, 1e-30)
        wq = zq / jnp.expm1(aq)
        d1 = d1 + htop * wq
        d2 = d2 + htop * (-(wq * wq + zq * wq))
    return d1, d2


def _joint_grad_hess(theta, stats, m: float, q: int, kmin: int = 0):
    """Analytic (gradient, Hessian) of _joint_logl at theta = log lambda —
    the value-free pass the Newton loop runs (see _joint_val_grad_hess for
    the derivation; this drops every log evaluation, which the derivatives
    never need).  Direct per-level exponentials, one (pairs, K)-vectorized
    op per quantity, which XLA fuses along the level axis."""
    la, lb, lx = jnp.exp(theta[0]), jnp.exp(theta[1]), jnp.exp(theta[2])

    gA, hA = _f_d1_d2(stats["gt_a"], la, m, q, kmin)          # w = (1,0,0)
    gB, hB = _f_d1_d2(stats["gt_b"], lb, m, q, kmin)          # w = (0,1,0)
    gAB, hAB = _f_d1_d2(stats["lt_b"], lb + lx, m, q, kmin)   # (0,1,1)
    gBA, hBA = _f_d1_d2(stats["lt_a"], la + lx, m, q, kmin)   # (1,0,1)
    ga = gA + gBA
    gb = gB + gAB
    gx = gAB + gBA
    Haa = hA + hBA
    Hbb = hB + hAB
    Hxx = hAB + hBA
    Hax = hBA
    Hbx = hAB
    Hab = jnp.zeros_like(Haa)

    kk, ax = _lvl_consts(stats, kmin)
    zk = jnp.where(kk <= q, jnp.exp2(-kk), 0.0)
    zk1f = jnp.where(kk >= 1, jnp.exp2(-(kk - 1.0)), 0.0)
    labx = (la + lb + lx) / m
    T1 = jnp.exp(-labx * zk)
    T4 = jnp.where(kk >= 1, jnp.exp(-labx * zk1f), 0.0)
    T2 = jnp.where(kk >= 1,
                   jnp.exp(-((la + lx) * zk1f + lb * zk) / m), 0.0)
    T3 = jnp.where(kk >= 1,
                   jnp.exp(-((lb + lx) * zk1f + la * zk) / m), 0.0)
    P = jnp.maximum(T1 - T2 - T3 + T4, 1e-30)
    return _joint_gh_tail(la, lb, lx, ga, gb, gx, Haa, Hbb, Hxx,
                          Hab, Hax, Hbx, zk, zk1f, T1, T2, T3, T4, P,
                          stats["eq"], ax, m)


def _joint_gh_tail(la, lb, lx, ga, gb, gx, Haa, Hbb, Hxx, Hab, Hax, Hbx,
                   zk, zk1f, T1, T2, T3, T4, P, w, ax, m: float):
    """Tail of _joint_grad_hess: the equal-level (diagonal) gradient/
    Hessian contributions from the T exponentials and P, then the chain
    rule into theta = log lambda."""
    wpos = w > 0
    Sa = -T1 * zk + T2 * zk1f + T3 * zk - T4 * zk1f
    Sb = -T1 * zk + T2 * zk + T3 * zk1f - T4 * zk1f
    Sx = -T1 * zk + T2 * zk1f + T3 * zk1f - T4 * zk1f
    wp = jnp.where(wpos, w / P, 0.0)
    ga = ga + (wp * Sa).sum(ax)
    gb = gb + (wp * Sb).sum(ax)
    gx = gx + (wp * Sx).sum(ax)
    z2, z12, zz1 = zk * zk, zk1f * zk1f, zk * zk1f
    wp2 = jnp.where(wpos, wp / P, 0.0)
    Haa = Haa + (wp * (T1 * z2 - T2 * z12 - T3 * z2 + T4 * z12)
                 - wp2 * Sa * Sa).sum(ax)
    Hbb = Hbb + (wp * (T1 * z2 - T2 * z2 - T3 * z12 + T4 * z12)
                 - wp2 * Sb * Sb).sum(ax)
    Hxx = Hxx + (wp * (T1 * z2 - T2 * z12 - T3 * z12 + T4 * z12)
                 - wp2 * Sx * Sx).sum(ax)
    Hab = Hab + (wp * (T1 * z2 - T2 * zz1 - T3 * zz1 + T4 * z12)
                 - wp2 * Sa * Sb).sum(ax)
    Hax = Hax + (wp * (T1 * z2 - T2 * z12 - T3 * zz1 + T4 * z12)
                 - wp2 * Sa * Sx).sum(ax)
    Hbx = Hbx + (wp * (T1 * z2 - T2 * zz1 - T3 * z12 + T4 * z12)
                 - wp2 * Sb * Sx).sum(ax)

    lam = jnp.stack([la, lb, lx])
    g_lam = jnp.stack([ga, gb, gx]) / m
    grad = lam * g_lam
    ll = lam[:, None] * lam[None, :] / (m * m)
    H_lam = jnp.stack([jnp.stack([Haa, Hab, Hax]),
                       jnp.stack([Hab, Hbb, Hbx]),
                       jnp.stack([Hax, Hbx, Hxx])])
    # batch-safe diag(grad) built by explicit stacking: jnp.diag only
    # accepts 1-D/2-D
    z = jnp.zeros_like(grad[0])
    diag = jnp.stack([jnp.stack([grad[0], z, z]),
                      jnp.stack([z, grad[1], z]),
                      jnp.stack([z, z, grad[2]])])
    hess = ll * H_lam + diag
    return grad, hess


def _joint_val_grad_hess(theta, stats, m: float, q: int,
                         kmin: int = 0):
    """Analytic (value, gradient, Hessian) of _joint_logl at theta = log
    lambda — one fused pass instead of value_and_grad + jacfwd(grad).

    Hand-derived out of necessity, not only speed: autodiff of _joint_logl
    is UNCONDITIONALLY nan (the z_{-1} = inf sentinel lane makes the where-
    branch cotangent 0 * inf), which had silently reduced the old Newton
    loop to its inclusion-exclusion initialization.  Verified to ~1e-7/1e-5
    relative against float64 central differences (tests/test_hll.py).

    Structure: every term of the likelihood is exp(-(c . lambda)/m) for a
    level-dependent coefficient vector c, so each term contributes
    T*c/(-m) to the gradient and T*c c^T/m^2 to the Hessian of its log."""
    la, lb, lx = jnp.exp(theta[0]), jnp.exp(theta[1]), jnp.exp(theta[2])

    # -- off-diagonal factors: four single-sketch likelihoods -------------
    vA, gA, hA = _f_val_d1_d2(stats["gt_a"], la, m, q, kmin)   # w = (1,0,0)
    vB, gB, hB = _f_val_d1_d2(stats["gt_b"], lb, m, q, kmin)   # w = (0,1,0)
    vAB, gAB, hAB = _f_val_d1_d2(stats["lt_b"], lb + lx, m, q, kmin)  # (0,1,1)
    vBA, gBA, hBA = _f_val_d1_d2(stats["lt_a"], la + lx, m, q, kmin)  # (1,0,1)
    val = vA + vB + vAB + vBA
    ga = gA + gBA
    gb = gB + gAB
    gx = gAB + gBA
    Haa = hA + hBA
    Hbb = hB + hAB
    Hxx = hAB + hBA
    Hax = hBA
    Hbx = hAB
    Hab = jnp.zeros_like(Haa)

    # -- diagonal (equal-register) term ------------------------------------
    kk = jnp.arange(kmin, kmin + stats["eq"].shape[-1], dtype=jnp.float32)
    zk = jnp.where(kk <= q, jnp.exp2(-kk), 0.0)
    zk1f = jnp.where(kk >= 1, jnp.exp2(-(kk - 1.0)), 0.0)   # z_{k-1}; 0 at k=0
    labx = (la + lb + lx) / m
    T1 = jnp.exp(-labx * zk)
    T4 = jnp.where(kk >= 1, jnp.exp(-labx * zk1f), 0.0)
    T2 = jnp.where(kk >= 1,
                   jnp.exp(-((la + lx) * zk1f + lb * zk) / m), 0.0)
    T3 = jnp.where(kk >= 1,
                   jnp.exp(-((lb + lx) * zk1f + la * zk) / m), 0.0)
    # clamp at a NORMAL f32 (subnormals flush to 0 on XLA) and zero
    # unobserved bins: their P can be 0 and 0 * -inf = nan otherwise
    P = jnp.maximum(T1 - T2 - T3 + T4, 1e-30)
    w = stats["eq"]
    wpos = w > 0
    val = val + jnp.where(wpos, w * jnp.log(P), 0.0).sum(-1)
    # first derivatives of P (times m)
    Sa = -T1 * zk + T2 * zk1f + T3 * zk - T4 * zk1f
    Sb = -T1 * zk + T2 * zk + T3 * zk1f - T4 * zk1f
    Sx = -T1 * zk + T2 * zk1f + T3 * zk1f - T4 * zk1f
    wp = jnp.where(wpos, w / P, 0.0)
    ga = ga + (wp * Sa).sum(-1)
    gb = gb + (wp * Sb).sum(-1)
    gx = gx + (wp * Sx).sum(-1)
    # second derivatives of P (times m^2), minus the rank-1 log correction
    z2, z12, zz1 = zk * zk, zk1f * zk1f, zk * zk1f
    wp2 = jnp.where(wpos, wp / P, 0.0)
    Haa = Haa + (wp * (T1 * z2 - T2 * z12 - T3 * z2 + T4 * z12)
                 - wp2 * Sa * Sa).sum(-1)
    Hbb = Hbb + (wp * (T1 * z2 - T2 * z2 - T3 * z12 + T4 * z12)
                 - wp2 * Sb * Sb).sum(-1)
    Hxx = Hxx + (wp * (T1 * z2 - T2 * z12 - T3 * z12 + T4 * z12)
                 - wp2 * Sx * Sx).sum(-1)
    Hab = Hab + (wp * (T1 * z2 - T2 * zz1 - T3 * zz1 + T4 * z12)
                 - wp2 * Sa * Sb).sum(-1)
    Hax = Hax + (wp * (T1 * z2 - T2 * z12 - T3 * zz1 + T4 * z12)
                 - wp2 * Sa * Sx).sum(-1)
    Hbx = Hbx + (wp * (T1 * z2 - T2 * zz1 - T3 * z12 + T4 * z12)
                 - wp2 * Sb * Sx).sum(-1)

    # -- chain rule into theta = log lambda --------------------------------
    lam = jnp.stack([la, lb, lx])
    g_lam = jnp.stack([ga, gb, gx]) / m
    grad = lam * g_lam
    ll = lam[:, None] * lam[None, :] / (m * m)
    H_lam = jnp.stack([jnp.stack([Haa, Hab, Hax]),
                       jnp.stack([Hab, Hbb, Hbx]),
                       jnp.stack([Hax, Hbx, Hxx])])
    # batch-safe diag(grad) built by explicit stacking: jnp.diag only
    # accepts 1-D/2-D
    z = jnp.zeros_like(grad[0])
    diag = jnp.stack([jnp.stack([grad[0], z, z]),
                      jnp.stack([z, grad[1], z]),
                      jnp.stack([z, z, grad[2]])])
    hess = ll * H_lam + diag
    return val, grad, hess


def _solve3_sym(H, g):
    """Closed-form symmetric 3x3 solve by adjugate — pure elementwise ops
    (batched jnp.linalg.solve on millions of 3x3s is far slower)."""
    a, b, c = H[0, 0], H[0, 1], H[0, 2]
    d, e = H[1, 1], H[1, 2]
    f = H[2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < 1e-30,
                jnp.where(det < 0, -1e-30, 1e-30), det)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    x0 = (A * g[0] + B * g[1] + C * g[2]) / det
    x1 = (B * g[0] + D * g[1] + E * g[2]) / det
    x2 = (C * g[0] + E * g[1] + F * g[2]) / det
    return jnp.stack([x0, x1, x2])


def jmle_iters(p: int) -> int:
    """Blind Newton iteration count for the joint MLE at precision p.

    Measured (benchmarks/jmle_iters_probe.py, 150 cases per p spanning
    cardinalities 2e3..6e7 and overlaps 0..0.9, f32 self-truth at
    iters=30): at p>=14 the trajectory is converged at 8 iterations
    (max |dJI| 4e-5, ~300x below the estimator's intrinsic error, and
    iters=10 itself wobbles more than 8 at the f32 noise floor); p=13
    and p=12 are also converged at 8 (max |dJI| 1.8e-4 and 1.5e-4 vs
    intrinsic errors of 1.2e-2 / 1.3e-2 — 67x / 86x below); at p=10 it
    still moves until 10 (iters=8 leaves 1.3e-3).  Fewer registers ->
    noisier Hessian -> slower convergence, so the count is p-dependent:
    2 fewer iterations is ~12% of the -J compare phase at the
    production p=14."""
    return 8 if p >= 12 else 10


@partial(jax.jit, static_argnames=("p", "iters", "kmin"))
def joint_mle(stats, p: int, iters: int = None, kmin: int = 0,
              cards=None) -> jnp.ndarray:
    """Maximize the joint likelihood; returns (|A\\B|, |B\\A|, |A&B|).

    `stats` is a dict of histograms (vmap over leading axes for batches)
    covering levels kmin..kmin+K-1 — kmin=0, K=q+2 is the full histogram,
    which is what hll_t::full_set_comparison / ertl_joint use (reference
    src/dashing.h:190, src/readfilt.cpp:118); the all-pairs engine passes
    the level window directly (exact when all registers fall inside it).

    `cards`, if given, is the (c_a, c_b, c_u) cardinality triple used for
    the inclusion-exclusion init.  The all-pairs engine precomputes c_a/c_b
    on the (n,)-marginals — per-pair recomputation was an n^2 redundancy
    that dominated the -J init cost.

    Newton acceptance: the loop runs the value-FREE gradient/Hessian pass
    (no log evaluations at all); divergence protection is ONE final
    likelihood comparison against the inclusion-exclusion init.  A
    trajectory that improves then degrades late could in principle return
    a point worse than an intermediate iterate (only worse-than-INIT is
    caught) — per-iterate best tracking was measured at a 30% -J
    throughput cost (extra carries spill + a third value evaluation).

    Round-4 quantification of that risk (600-case sweep of per-iterate
    likelihood traces over cardinalities 1e2.5..1e6.5 and overlaps
    0..0.95 at p in {10,12,14}): late degradations DO occur (163/600
    trajectories end below their best iterate) but every one is f32
    noise-floor wobble — the worst JI difference between the best
    iterate and the returned final is 1.6e-4, ~100x below the
    estimator's intrinsic error at those precisions (1.2e-2 at p=12).
    A midpoint/best-iterate guard therefore buys nothing measurable
    while paying an extra likelihood evaluation per pair, so it is
    deliberately NOT implemented; the bound is pinned
    by tests/test_accuracy.py::test_jmle_trajectory_degradation_bounded,
    which fails if trajectory degradation ever becomes material.
    """
    m = float(1 << p)
    q = 64 - p
    if iters is None:
        iters = jmle_iters(p)
    if cards is None:
        cards = (mle_estimate_windowed(stats["hist_a"], p, kmin),
                 mle_estimate_windowed(stats["hist_b"], p, kmin),
                 mle_estimate_windowed(stats["hist_u"], p, kmin))
    la, lb, lx = joint_mle_core(stats, cards, m, q, kmin, iters)
    return jnp.stack([la, lb, lx])


def joint_mle_core(stats, cards, m: float, q: int, kmin: int, iters: int):
    """The Newton loop of joint_mle, batch-explicit: all component
    reductions run over axis 0 (the 3-vector axis) so arbitrary trailing
    batch dims work WITHOUT vmap — identical ops for the scalar case
    (sum() == sum(0) on a (3,) vector)."""
    c_a, c_b, c_u = cards
    # disjoint / degenerate initializations, clamped to a tiny positive rate
    tiny = 1e-3
    la0 = jnp.maximum(c_u - c_b, tiny)
    lb0 = jnp.maximum(c_u - c_a, tiny)
    lx0 = jnp.maximum(c_a + c_b - c_u, tiny)
    theta0 = jnp.stack([jnp.log(la0), jnp.log(lb0), jnp.log(lx0)])

    def body(_, theta):
        g, H = _joint_grad_hess(theta, stats, m, q, kmin)
        # damp the diagonal by explicit stacking; subtracting literal 0.0
        # off-diagonal is a float no-op, so this is bit-identical to
        # H - 1e-4*eye
        H = jnp.stack([
            jnp.stack([H[0, 0] - 1e-4, H[0, 1], H[0, 2]]),
            jnp.stack([H[1, 0], H[1, 1] - 1e-4, H[1, 2]]),
            jnp.stack([H[2, 0], H[2, 1], H[2, 2] - 1e-4])])
        step = _solve3_sym(H, g)
        step = jnp.where(jnp.isfinite(step), step, 0.0)
        norm = jnp.sqrt((step ** 2).sum(0))
        step = step * jnp.minimum(1.0, 2.0 / jnp.maximum(norm, 1e-9))
        new = theta - step
        return jnp.where(jnp.isfinite(new).all(0), new, theta)

    theta = jax.lax.fori_loop(0, iters, body, theta0)
    final_val = _joint_logl(theta, stats, m, q, kmin)
    init_val = _joint_logl(theta0, stats, m, q, kmin)
    theta = jnp.where(jnp.isfinite(final_val) & (final_val >= init_val),
                      theta, theta0)
    la, lb, lx = jnp.exp(theta[0]), jnp.exp(theta[1]), jnp.exp(theta[2])
    # Degenerate cases: empty sketches.
    a_empty = c_a <= 0.0
    b_empty = c_b <= 0.0
    la = jnp.where(a_empty, 0.0, la)
    lx = jnp.where(a_empty | b_empty, 0.0, lx)
    lb = jnp.where(b_empty, 0.0, lb)
    return la, lb, lx


# ---------------------------------------------------------------------------
# Set-operation helpers used by the measures layer.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("p", "method"))
def union_triple_incl_excl(hist_a, hist_b, hist_u, p: int, method: int = ERTL_MLE):
    """(onlyA, onlyB, shared) by inclusion-exclusion on three cardinalities
    (the reference's non-JMLE path: us::intersection_size,
    reference src/dashing.h:550-552)."""
    c_a = estimate(hist_a, p, method)
    c_b = estimate(hist_b, p, method)
    c_u = estimate(hist_u, p, method)
    shared = jnp.maximum(0.0, c_a + c_b - c_u)
    return jnp.stack([jnp.maximum(c_a - shared, 0.0),
                      jnp.maximum(c_b - shared, 0.0),
                      shared], axis=-1)


# ---------------------------------------------------------------------------
# Host (numpy, float64) reference implementations, used by the test-suite to
# bound the f32 device error and as documentation of the math.
# ---------------------------------------------------------------------------

def mle_estimate_np(C: np.ndarray, p: int) -> float:
    m = float(1 << p)
    q = len(C) - 2
    C = np.asarray(C, np.float64)
    if C[0] >= C.sum():
        return 0.0
    if C[-1] >= C.sum():
        return float("inf")

    def dlogl(x):
        k = np.arange(1, q + 1)
        zk = 2.0 ** -k
        a = x * zk
        mid = (C[1:q + 1] * zk * (-1.0 + 1.0 / np.expm1(np.maximum(a, 1e-300)))).sum()
        zq = 2.0 ** -q
        top = C[q + 1] * zq / np.expm1(max(x * zq, 1e-300))
        return -C[0] + mid + top

    lo, hi = 1e-12, 2.0 ** (q + 4)
    for _ in range(200):
        mid = math.sqrt(lo * hi)
        if dlogl(mid) > 0:
            lo = mid
        else:
            hi = mid
    return math.sqrt(lo * hi) * m
