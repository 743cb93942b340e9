"""The pairwise register statistics against brute-force counts."""
import numpy as np
import jax.numpy as jnp
import pytest

from dashing_tpu.ops import pairwise as pw


def _brute_stats(a, b, kmin, kmax):
    """Per-pair histograms of the five joint statistics by direct
    counting: eq[k] = #(a=k=b), gt_a[k] = #(a=k>b), gt_b[k] = #(b=k>a),
    cum_union[k] = #(max(a, b) <= k)."""
    na, nb = a.shape[0], b.shape[0]
    K = kmax - kmin + 1
    out = {n: np.zeros((na, nb, K), np.float32)
           for n in ("cum_union", "eq", "gt_a", "gt_b")}
    for i in range(na):
        for j in range(nb):
            x, y = a[i], b[j]
            for t, lv in enumerate(range(kmin, kmax + 1)):
                out["cum_union"][i, j, t] = np.sum(np.maximum(x, y) <= lv)
                out["eq"][i, j, t] = np.sum((x == lv) & (y == lv))
                out["gt_a"][i, j, t] = np.sum((x == lv) & (y < lv))
                out["gt_b"][i, j, t] = np.sum((y == lv) & (x < lv))
    return out


@pytest.mark.parametrize("kmin", [0, 3])
@pytest.mark.parametrize("joint,same", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_pair_stats_brute_force(joint, same, kmin):
    rng = np.random.default_rng(7)
    kmax = kmin + 8
    a = np.clip(rng.geometric(0.4, size=(5, 256)) + kmin - 1, kmin,
                kmax - 1).astype(np.int32)
    b = a if same else np.clip(rng.geometric(0.4, size=(4, 256)) + kmin - 1,
                               kmin, kmax - 1).astype(np.int32)
    got = pw.pair_stats(jnp.asarray(a), jnp.asarray(b), kmax, joint, kmin,
                        same=same)
    want = _brute_stats(a, b, kmin, kmax)
    names = ("cum_union", "eq", "gt_a", "gt_b") if joint else ("cum_union",)
    for n in names:
        np.testing.assert_array_equal(np.asarray(got[n]), want[n], err_msg=n)
    levels = np.arange(kmin, kmax + 1)
    for n, x in (("hist_a", a), ("hist_b", b)):
        np.testing.assert_array_equal(
            np.asarray(got[n]), (x[:, :, None] == levels).sum(1), err_msg=n)
