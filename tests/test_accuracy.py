"""CI-grade estimator accuracy regression (ADVICE r2 item 1).

The joint MLE runs a fixed 10 blind Newton steps with only a final
likelihood guard — a silent-accuracy risk class if a refactor degrades the
trajectory.  The full sweep (benchmarks/estimator_sweep.py, 30 trials,
p in {10,14,18}) stays the measurement of record; this fixed-seed
mini-sweep pins the p=14 numbers in CI so a regression fails loudly.

Recorded sweep values (BENCH_NOTES): JMLE Jaccard RMSE at p=14 = 0.0034
(incl-excl: 0.0058); MLE cardinality relative RMSE at p=14 ~ the 1.04/
sqrt(m) = 0.0081 HLL bound.  Thresholds below leave ~50% headroom over
the deterministic fixed-seed values, far under the broken-estimator
failure modes (IE-level 0.006+, or divergence >0.05).
"""
import numpy as np

from dashing_tpu.sketch import estimators as est
from dashing_tpu.sketch.hll import HLL

TRIALS = 8
P = 14


def test_jmle_jaccard_rmse_pinned():
    rng = np.random.default_rng(1234)
    errs = []
    for _ in range(TRIALS):
        n = 30_000
        shared = rng.integers(0, 2**62, n, dtype=np.uint64)
        a = HLL(P, jestim=est.ERTL_JOINT_MLE)
        b = HLL(P, jestim=est.ERTL_JOINT_MLE)
        a.addh_np(np.concatenate(
            [shared, rng.integers(2**62, 2**63, n, dtype=np.uint64)]))
        b.addh_np(np.concatenate(
            [shared, rng.integers(2**63, 2**64 - 1, n, dtype=np.uint64)]))
        errs.append(a.jaccard_index(b) - 1.0 / 3.0)
    rmse = float(np.sqrt(np.mean(np.square(errs))))
    # fixed-seed deterministic; recorded 30-trial sweep value 0.0034
    assert rmse < 0.005, rmse


def test_mle_cardinality_rmse_pinned():
    rng = np.random.default_rng(99)
    errs = []
    for _ in range(TRIALS):
        n = 100_000
        h = HLL(P)
        h.addh_np(rng.integers(0, 2**63, n, dtype=np.uint64))
        errs.append(h.report() / n - 1.0)
    rmse = float(np.sqrt(np.mean(np.square(errs))))
    # HLL theoretical sigma at p=14 is 1.04/sqrt(2^14) = 0.0081
    assert rmse < 0.012, rmse


def test_jmle_trajectory_degradation_bounded():
    """Evidence for the joint_mle final-vs-init guard decision (ADVICE r2
    / VERDICT r3 weakness 4): Newton trajectories that improve then
    degrade late exist, but only at the f32 noise floor.  This test
    re-runs per-iterate likelihood traces (mirroring joint_mle_core's
    body) over a case sweep and asserts the JI gap between the BEST
    iterate and the returned FINAL iterate stays ~100x below the
    estimator's intrinsic error — if a change ever makes trajectories
    degrade materially, this fails and a best-iterate guard becomes
    warranted."""
    import functools
    import jax
    import jax.numpy as jnp

    def sim_regs(rng, n, m, q):
        counts = rng.multinomial(n, np.full(m, 1.0 / m))
        r = np.zeros(m, np.int64)
        nz = counts > 0
        u = rng.uniform(size=int(nz.sum()))
        c = counts[nz].astype(np.float64)
        val = np.ceil(-np.log2(np.maximum(1e-300, 1.0 - u ** (1.0 / c))))
        r[nz] = np.minimum(val, q + 1).astype(np.int64)
        return r

    def stats_from_regs(a, b, q):
        lev = np.arange(q + 2)
        ha = (a[:, None] == lev).sum(0).astype(np.float32)
        hb = (b[:, None] == lev).sum(0).astype(np.float32)
        hu = (np.maximum(a, b)[:, None] == lev).sum(0).astype(np.float32)
        eq = ((a[:, None] == lev) & (b == a)[:, None]).sum(0).astype(
            np.float32)
        gta = ((a[:, None] == lev) & (a > b)[:, None]).sum(0).astype(
            np.float32)
        gtb = ((b[:, None] == lev) & (b > a)[:, None]).sum(0).astype(
            np.float32)
        return dict(hist_a=ha, hist_b=hb, hist_u=hu, eq=eq, gt_a=gta,
                    gt_b=gtb, lt_a=ha - eq - gta, lt_b=hb - eq - gtb)

    @functools.partial(jax.jit, static_argnames=("p", "iters"))
    def traces(sN, p, iters):
        m = float(1 << p)
        q = 64 - p
        kmin = 0
        c_a = est.mle_estimate_windowed(sN["hist_a"], p, kmin)
        c_b = est.mle_estimate_windowed(sN["hist_b"], p, kmin)
        c_u = est.mle_estimate_windowed(sN["hist_u"], p, kmin)
        tiny = 1e-3
        th = jnp.stack([jnp.log(jnp.maximum(c_u - c_b, tiny)),
                        jnp.log(jnp.maximum(c_u - c_a, tiny)),
                        jnp.log(jnp.maximum(c_a + c_b - c_u, tiny))])

        def logl(theta):
            return jax.vmap(
                lambda t, s: est._joint_logl(t, s, m, q, kmin),
                in_axes=(1, 0))(theta, sN)

        def body(carry, _):
            t = carry
            g, H = jax.vmap(
                lambda tt, s: est._joint_grad_hess(tt, s, m, q, kmin),
                in_axes=(1, 0), out_axes=(1, 2))(t, sN)
            H = jnp.stack([
                jnp.stack([H[0, 0] - 1e-4, H[0, 1], H[0, 2]]),
                jnp.stack([H[1, 0], H[1, 1] - 1e-4, H[1, 2]]),
                jnp.stack([H[2, 0], H[2, 1], H[2, 2] - 1e-4])])
            step = est._solve3_sym(H, g)
            step = jnp.where(jnp.isfinite(step), step, 0.0)
            nrm = jnp.sqrt((step ** 2).sum(0))
            step = step * jnp.minimum(1.0, 2.0 / jnp.maximum(nrm, 1e-9))
            new = t - step
            t = jnp.where(jnp.isfinite(new).all(0), new, t)
            return t, (logl(t), t)

        v0 = logl(th)
        _, (vals, ths) = jax.lax.scan(body, th, None,
                                      length=iters)
        return (jnp.concatenate([v0[None], vals], 0),
                jnp.concatenate([th[None], ths], 0))

    rng = np.random.default_rng(7)
    for p, intrinsic in ((12, 1.2e-2), (14, 3.3e-3)):
        m, q = 1 << p, 64 - p
        iters = est.jmle_iters(p)
        S = []
        for _ in range(40):
            na = int(10 ** rng.uniform(2.5, 6.0))
            nb = int(10 ** rng.uniform(2.5, 6.0))
            ns = int(min(na, nb) * rng.uniform(0, 0.95))
            ra = sim_regs(rng, max(na - ns, 1), m, q)
            rb = sim_regs(rng, max(nb - ns, 1), m, q)
            rs = (sim_regs(rng, ns, m, q) if ns > 0
                  else np.zeros(m, np.int64))
            S.append(stats_from_regs(np.maximum(ra, rs),
                                     np.maximum(rb, rs), q))
        batch = {k: jnp.asarray(np.stack([s[k] for s in S]))
                 for k in S[0]}
        vals, ths = traces(batch, p, iters)
        vals, ths = np.asarray(vals), np.asarray(ths)
        best_i = np.nanargmax(np.where(np.isfinite(vals), vals, -np.inf), 0)
        ji = (np.exp(ths[:, 2, :])
              / np.maximum(np.exp(ths).sum(1), 1e-30))
        cols = np.arange(ji.shape[1])
        dji = np.abs(ji[best_i, cols] - ji[-1])
        # late degradation must stay far below intrinsic error (observed
        # max 1.6e-4 across 600 cases; alarm at ~a tenth of intrinsic)
        assert float(dji.max()) < intrinsic / 8, (p, float(dji.max()))
