"""Phase split of the -J compare tile at the production geometry: stats
matmuls vs triple assembly/init vs Newton iterations.

Run on the GPU:  python benchmarks/jmle_profile.py [n] [p]
Feeds the decision record in PERF.md (which phase to attack next).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

import _common
_common.setup()



def main(n: int = 1024, p: int = 14):
    import jax
    import jax.numpy as jnp
    from dashing_tpu.ops import pairwise as pw
    from dashing_tpu.sketch import estimators as est

    rng = np.random.default_rng(0)
    lam = 5e6 / (1 << p)
    regs = np.minimum(
        rng.geometric(0.5, size=(n, 1 << p)) - 1 +
        np.maximum(np.log2(lam), 0).astype(np.int64), 64 - p + 1
    ).astype(np.int32)
    kmin, kmax = int(regs.min()), int(regs.max()) + 1
    print(f"n={n} p={p} levels [{kmin}, {kmax}]", file=sys.stderr)
    a = jnp.asarray(regs)
    REPS = 8

    def timed(fn):
        loop = jax.jit(lambda a: jax.lax.fori_loop(
            0, REPS,
            lambda i, acc: acc + fn(
                a.at[0, 0].add((acc - jnp.floor(acc) > 2.0).astype(a.dtype))),
            jnp.float32(0.0)))
        _ = jax.device_get(loop(a))
        dt = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            _ = jax.device_get(loop(a))
            dt = min(dt, (time.perf_counter() - t0) / REPS)
        return dt

    def stats_only(aa):
        st = pw.pair_stats(aa, aa, kmax, True, kmin, same=True)
        return sum(v.sum() for v in st.values())

    def triples_iters(iters):
        def fn(aa):
            st = pw.pair_stats(aa, aa, kmax, True, kmin, same=True)
            cum = st["cum_union"]
            hist_u_w = jnp.concatenate(
                [cum[..., :1], cum[..., 1:] - cum[..., :-1]], axis=-1)
            eq, gt_a, gt_b = st["eq"], st["gt_a"], st["gt_b"]
            ha = jnp.broadcast_to(st["hist_a"][:, None, :], eq.shape)
            hb = jnp.broadcast_to(st["hist_b"][None, :, :], eq.shape)
            c_a = est.mle_estimate_windowed(st["hist_a"], p, kmin)
            c_b = est.mle_estimate_windowed(st["hist_b"], p, kmin)
            c_u = est.improved_estimate_windowed(hist_u_w, p, kmin)
            flat = lambda x: x.reshape(-1, x.shape[-1])
            sdict = dict(eq=flat(eq), gt_a=flat(gt_a), gt_b=flat(gt_b),
                         lt_a=flat(ha - eq - gt_a), lt_b=flat(hb - eq - gt_b))
            cards = (jnp.broadcast_to(c_a[:, None], (n, n)).reshape(-1),
                     jnp.broadcast_to(c_b[None, :], (n, n)).reshape(-1),
                     c_u.reshape(-1))
            tri = jax.vmap(lambda s, c: est.joint_mle(
                s, p, iters=iters, kmin=kmin, cards=c))(sdict, cards)
            return tri.sum()
        return fn

    t_stats = timed(stats_only)
    t_i0 = timed(triples_iters(0))
    t_i4 = timed(triples_iters(4))
    t_full = timed(triples_iters(10))
    per_iter = (t_i4 - t_i0) / 4
    print(f"stats(same=True):        {t_stats*1e3:7.1f} ms")
    print(f"+assembly+init (it=0):   {t_i0*1e3:7.1f} ms "
          f"(delta {1e3*(t_i0-t_stats):.1f})")
    print(f"full (it=10):            {t_full*1e3:7.1f} ms  "
          f"-> {n*n/t_full/1e6:.1f}M pairs/s")
    print(f"Newton per-iter:         {per_iter*1e3:7.2f} ms "
          f"(x10 = {per_iter*1e4:.1f} ms)")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1024,
         int(sys.argv[2]) if len(sys.argv) > 2 else 14)
