"""The sort probe's kernels (K7 bitonic column sort, K8 row gather) and the
probe of rtts_torch against the JAX package's ``scripts/probe_vmem_sort.py``,
small, on the CPU.

The same numpy inputs go through the JAX kernels in Pallas interpret mode
and the port's plain versions (which the wrappers run for CPU tensors).
Sorting and gathering move values, so every comparison is exact.
"""

import pathlib
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts.attention import lsh as JL
from rtts.config import load_yaml
from rtts_torch.ops import bitonic_sort as K7
from rtts_torch.ops import row_gather as K8
from rtts_torch.probes import probe_vmem_sort as P


ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

from probe_vmem_sort import bitonic_sort_cols as jax_sort  # noqa: E402
from probe_vmem_sort import vmem_row_gather as jax_gather  # noqa: E402
from torch_twin import one_thread  # noqa: F401  (autouse)


def _sorted_by_jax(x: np.ndarray) -> np.ndarray:
    return np.asarray(jax_sort(jnp.asarray(x), interpret=True))


# -- K7 ------------------------------------------------------------------------------


@pytest.mark.parametrize("n,c", [(64, 8), (256, 128), (1024, 16)])
def test_bitonic_reference_equals_jax_kernel(n, c):
    x = np.random.default_rng(n).integers(0, 1 << 20, (n, c), dtype=np.int32)
    got = K7.bitonic_sort_cols_reference(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _sorted_by_jax(x))
    np.testing.assert_array_equal(got, np.sort(x, axis=0))


def test_bitonic_reference_carries_the_packed_permutation():
    """key = bucket * L + pos: the sorted keys give the sorted buckets and,
    as key % L, the stable order; as the JAX kernel does."""
    rng = np.random.default_rng(1)
    l, c = 128, 4
    buckets = rng.integers(0, 7, (l, c), dtype=np.int32)
    packed = buckets * l + np.arange(l, dtype=np.int32)[:, None]
    got = K7.bitonic_sort_cols_reference(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, _sorted_by_jax(packed))
    for col in range(c):
        np.testing.assert_array_equal(
            got[:, col] % l, np.argsort(buckets[:, col], kind="stable"))
        np.testing.assert_array_equal(got[:, col] // l,
                                      np.sort(buckets[:, col]))


@pytest.mark.parametrize("x", [
    [[5, 0], [5, -(1 << 30)], [0, 1 << 30], [5, 0]],
    [[-(2**31)], [2**31 - 1], [0], [-1], [2**31 - 1], [-(2**31)], [7], [7]],
    [[3, 3, 3]],
])
def test_bitonic_reference_duplicates_and_extremes(x):
    x = np.asarray(x, np.int32)
    got = K7.bitonic_sort_cols_reference(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.sort(x, axis=0))
    np.testing.assert_array_equal(got, _sorted_by_jax(x))


@pytest.mark.parametrize("n", [3, 6, 100, 0])
def test_bitonic_refuses_a_length_not_a_power_of_two(n):
    with pytest.raises(ValueError, match="power of two"):
        K7.bitonic_sort_cols(torch.zeros((n, 4), dtype=torch.int32))


def test_bitonic_refuses_other_dtypes_and_ranks():
    for x in (torch.zeros((8, 2), dtype=torch.int64),
              torch.zeros((8,), dtype=torch.int32)):
        with pytest.raises(ValueError, match="int32"):
            K7.bitonic_sort_cols(x)


@pytest.mark.parametrize("n,cols,sms,want", [
    (8192, 64, 132, 1), (4096, 128, 132, 1), (1024, 256, 132, 1),
    (1024, 2048, 132, 8), (1024, 528, 132, 4), (32768, 2048, 132, 1),
    # 1024 threads hold a column of 8192 keys: one column a block
    (8192, 2048, 132, 1), (64, 8, 1, 8), (64, 12, 1, 4),
    # short columns: enough of them to make a warp
    (1, 3, 132, 32), (16, 5, 1, 16)])
def test_columns_per_block(n, cols, sms, want):
    assert K7.columns_per_block(n, cols, sms) == want


# -- K7's path entry: the LSH bucket sort -------------------------------------------


def _k7_recipe(buckets: np.ndarray):
    """What K7's path entry computes, with its column entry's plain
    version: keys bucket * L + pos, each row padded with INT32_MAX to a
    power of two (at least 8) and sorted; slot s < L holds position key % L
    and bucket key // L, and undo[position] = s."""
    *lead, l = buckets.shape
    rows = buckets.reshape(-1, l).astype(np.int64)
    p = max(1 << (l - 1).bit_length(), 8)
    keys = np.full((p, rows.shape[0]), np.iinfo(np.int32).max, np.int32)
    keys[:l] = (rows * l + np.arange(l)).T
    got = K7.bitonic_sort_cols_reference(torch.from_numpy(keys)).numpy()
    got = got[:l].T
    pos, bucket = got % l, got // l
    undo = np.empty_like(pos)
    np.put_along_axis(undo, pos, np.broadcast_to(np.arange(l), pos.shape), -1)
    return [a.reshape(*lead, l) for a in (pos, undo, bucket)]


@pytest.mark.parametrize("shape,nb", [((2, 2, 2, 96), 16), ((1, 2, 1, 5), 4),
                                      ((2, 1, 3, 64), 8), ((1, 1, 2, 1), 2)])
def test_k7_recipe_and_wrapper_equal_jax_sort_by_bucket(shape, nb):
    """Padding goes to the overflow bucket nb: a ragged tail in the last
    batch row, and the first (batch, head) masked whole."""
    rng = np.random.default_rng(sum(shape))
    buckets = rng.integers(0, nb, shape).astype(np.int32)
    buckets[-1, ..., shape[-1] // 2:] = nb
    buckets[0, 0] = nb
    want = [np.asarray(w) for w in JL._sort_by_bucket(jnp.asarray(buckets))]
    for got, w in zip(_k7_recipe(buckets), want):
        np.testing.assert_array_equal(got, w)
    got = K7.sort_by_bucket(torch.from_numpy(buckets).long())
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("rows,l,sms,want", [
    (64, 8192, 132, (2, 1)),     # longform decoder: a 2-CTA cluster a row
    (64, 4096, 132, (2, 1)), (64, 2048, 132, (1, 1)),
    (64, 1024, 132, (1, 1)),     # longform encoder: one CTA a row
    (256, 1024, 132, (1, 1)),    # serving_fast decoder
    (256, 256, 132, (1, 1)),     # serving_fast encoder: a warp a row
    (2048, 256, 132, (1, 8)),    # many short rows share a block
    (1, 5, 132, (1, 32)), (40, 16, 1, (1, 128)),
    (64, K7.MAX_ROWS, 132, (2, 1)), (200, K7.MAX_ROWS, 132, (1, 1)),
    (3, K7.MAX_ROWS + 1, 132, None), (0, 64, 132, None), (4, 0, 132, None)])
def test_sort_route(rows, l, sms, want):
    assert K7.sort_route(rows, l, sms) == want


def test_sort_routes_launch_whole_warps_within_the_limits():
    for rows in (1, 3, 64, 131, 132, 1000):
        for l in (1, 2, 7, 8, 9, 100, 256, 257, 1000, 4096, 8192, 9000,
                  K7.MAX_ROWS):
            cluster, block = K7.sort_route(rows, l, 132)
            keys = max(1 << (l - 1).bit_length(), 8) // cluster
            threads = block * K7._threads_a_row(keys)
            assert threads % 32 == 0 and threads <= 1024, (rows, l)
            assert block * keys * 4 <= K7._SMEM_BYTES, (rows, l)


def test_sort_by_bucket_refuses_other_dtypes_ranks_and_devices():
    for x in (torch.zeros((4, 8)), torch.zeros((4, 8), dtype=torch.int32),
              torch.tensor(3)):
        with pytest.raises(ValueError, match="int64"):
            K7.sort_by_bucket(x)
    with pytest.raises(ValueError, match="device"):
        K7.sort_by_bucket(torch.zeros((4, 8), dtype=torch.int64,
                                      device="meta"))


def test_sort_by_bucket_takes_the_plain_version_on_cpu_tensors():
    buckets = torch.randint(0, 9, (3, 2, 100),
                            generator=torch.Generator().manual_seed(0))
    launches = K7.sort_by_bucket.launches
    got = K7.sort_by_bucket(buckets)
    for g, w in zip(got, K7.sort_by_bucket_reference(buckets)):
        assert torch.equal(g, w)
    assert K7.sort_by_bucket.launches == launches


# -- K8 ------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("repeats", [False, True])
def test_row_gather_reference_equals_jax_kernel(dtype, repeats):
    rng = np.random.default_rng(2)
    rows, d = 128, 40
    x = rng.standard_normal((rows, d)).astype(np.float32)
    idx = (rng.integers(0, rows, rows) if repeats
           else rng.permutation(rows)).astype(np.int32)
    want = np.asarray(jax_gather(jnp.asarray(x, dtype), jnp.asarray(idx),
                                 interpret=True)).astype(np.float32)
    tdtype = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = K8.row_gather_reference(torch.from_numpy(x).to(tdtype),
                                  torch.from_numpy(idx))
    assert got.dtype == tdtype and got.shape == (rows, d)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(got.float().numpy(),
                                  x[idx].astype(dtype).astype(np.float32))


def test_wrappers_take_the_plain_versions_on_cpu_tensors():
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.integers(-9, 9, (32, 5), dtype=np.int32))
    x = torch.from_numpy(rng.standard_normal((16, 6)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 16, 24).astype(np.int32))
    launches = (K7.bitonic_sort_cols.launches, K8.row_gather.launches)
    assert torch.equal(K7.bitonic_sort_cols(keys),
                       K7.bitonic_sort_cols_reference(keys))
    assert torch.equal(K8.row_gather(x, idx), x[idx.long()])
    assert (K7.bitonic_sort_cols.launches, K8.row_gather.launches) == launches
    with pytest.raises(IndexError):
        K8.row_gather(x, torch.tensor([16], dtype=torch.int32))


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="device"):
        K7.bitonic_sort_cols(torch.zeros((8, 2), dtype=torch.int32,
                                         device="meta"))
    with pytest.raises(ValueError, match="device"):
        K8.row_gather(torch.zeros((8, 2), device="meta"),
                      torch.zeros(8, dtype=torch.int32, device="meta"))


# -- the probe -----------------------------------------------------------------------


def test_probe_check_passes_on_cpu(capsys):
    assert P.main(["--check", "--device", "cpu"]) == 0
    assert "checks OK on cpu (the plain versions)" in capsys.readouterr().out


def test_probe_bench_refuses_the_cpu():
    with pytest.raises(SystemExit):
        P.main(["--device", "cpu"])


def test_probe_bench_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.bench()


@pytest.mark.parametrize("name,yaml", [("longform_8k", "longform_8k.yaml"),
                                       ("serving_fast", "serving_fast.yaml")])
def test_probe_step_models_equal_the_configs(name, yaml):
    assert P.STEP_MODELS[name][0] == load_yaml(ROOT / "configs" / yaml)["model"]


def test_lsh_buckets_pack_the_sort_keys():
    buckets, keys = P.lsh_buckets(2, 3, 2, 64, device="cpu")
    assert buckets.shape == (2, 3, 2, 64) and keys.shape == (64, 12)
    assert int(buckets.max()) < P.TL.auto_num_buckets(64, P.CHUNK)
    sorted_keys = K7.bitonic_sort_cols(keys)
    pos, _, sorted_buckets = P.TL._sort_by_bucket(buckets)
    np.testing.assert_array_equal(sorted_keys.t().reshape(2, 3, 2, 64) % 64,
                                  pos)
    np.testing.assert_array_equal(sorted_keys.t().reshape(2, 3, 2, 64) // 64,
                                  sorted_buckets)


def test_bounds_count_the_bytes_and_compare_exchanges():
    work = P.sort_bound(8, 3)
    # log2(8) = 3: 6 passes of 4 compare-exchanges per column
    assert work == {"bytes": 2 * 4 * 8 * 3, "ops": 2 * 6 * 4 * 3,
                    "compare_exchanges": 6 * 4 * 3}
    x = torch.zeros((10, 6), dtype=torch.bfloat16)
    flat = torch.tensor([1, 1, 3, 9], dtype=torch.int32)
    # three distinct rows read, four indices read, four rows written
    assert P.gather_bound(x, flat) == {"bytes": 3 * 12 + 4 * (4 + 12),
                                       "ops": 0}


def _event(name, us, parent=None):
    return types.SimpleNamespace(name=name, device_time_total=us,
                                 cpu_parent=parent)


def test_sort_gather_share_counts_enclosed_ops_once():
    """argsort calls sort: only the outermost of the three ops counts, with
    its children's device time; other ops do not count."""
    argsort = _event("aten::argsort", 30.0)
    backward = _event("_PermRowsTakeBackward", 50.0)
    events = [argsort, _event("aten::sort", 25.0, argsort),
              _event("aten::sort", 10.0), _event("aten::gather", 20.0),
              backward, _event("aten::gather", 15.0, backward),
              _event("aten::mm", 500.0)]
    share = P.sort_gather_share(events, 1000.0)
    assert share["by_op_us"] == {"aten::sort": 10.0, "aten::argsort": 30.0,
                                 "aten::gather": 35.0, "K7 sort_by_bucket": 0.0}
    assert share["us"] == 75.0 and share["share"] == 0.075
    # K7's path entry (no aten op holds it) adds its kernels' time
    share = P.sort_gather_share(events, 1000.0, k7_us=25.0)
    assert share["by_op_us"]["K7 sort_by_bucket"] == 25.0
    assert share["us"] == 100.0 and share["share"] == 0.1


def test_verdict_needs_a_share_and_two_faster_primitives():
    def result(share, k7, k8):
        return {"sort": {"longform b2 h8 nh4 L8192": {
                    "sort_by_bucket_reference": 1.0, "K7": k7}},
                "gather": {"longform (16, 32768, 128) bf16": {
                    "_perm_rows_take": 1.0, "K8": k8}},
                "share": {"longform_8k": {"share": share},
                          "serving_fast": {"share": 0.01}}}

    assert P.verdict(result(0.2, 0.5, 0.5))["pays"]
    assert not P.verdict(result(0.01, 0.5, 0.5))["pays"]
    assert not P.verdict(result(0.2, 2.0, 0.5))["pays"]
    assert not P.verdict(result(0.2, 0.5, 2.0))["pays"]
