"""Sequence and pipeline parallelism in the port against the JAX package's,
on the CPU (the second half of ``tests/test_torch_parallel.py``, split
off so that the two halves' rank processes and JAX compiles run on two
workers).

The port's rank cases (``seq_attn`` and ``stack``) run in rank processes
(``tests/torch_parallel_ranks.py``, with JAX and the JAX package blocked)
over gloo, a group of 2 ranks and one of 4, started before the JAX side
compiles; JAX's side runs on its virtual mesh (2 devices, or data 2 x
model 2), flash off (its naive sequence-parallel path draws the kernels'
counter hash too), LSH with the rotations of PRNGKey(hash_seed) injected
into the port.  Tolerances: the reference's own, outputs 1e-5 and
gradients 3e-5 (abs + rel).  Also: a sequence-parallel rank's K1/K3 keep
bits, the LSH window's dropout lanes, the pipeline's per-microbatch
dropout and every refusal of the reference's pipeline and
sequence-parallel paths.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts.config import MeshConfig as JMeshConfig
from rtts.config import to_dict
from rtts.ops.flash_attention import dropout_keep_mask as jax_keep_mask
from rtts.parallel.mesh import make_mesh as jax_make_mesh
from rtts_torch import config as TC
from rtts_torch.ops.flash_attention import dropout_keep_mask
from tests.test_torch_parallel import _paths, collect, spawn
from tests.test_torch_train import np_tree, tt
from torch_twin import one_thread  # noqa: F401  (autouse)


SEQ_TOL = 1e-5
SEQ_GRAD_TOL = 3e-5
SEQ_HASH_SEED = 3
SEQ_DROP_KEY = 9


def _jmesh(dp, mp, dcn=1):
    return jax_make_mesh(JMeshConfig(data_parallel=dp, model_parallel=mp,
                                     dcn_parallel=dcn),
                         jax.devices()[:dcn * dp * mp])


def _seq_attention_cfg(kind, **kw):
    from rtts.config import AttentionConfig as JA

    if kind == "full":
        return JA(kind="full", num_heads=2, head_dim=16, chunk_length=16,
                  flash=False, **kw)
    return JA(kind="lsh", num_heads=2, head_dim=16, num_hashes=2,
              num_buckets=8, chunk_length=16, num_chunks_before=1,
              num_chunks_after=0, use_pallas=False, flash=False, **kw)


def _seq_specs():
    """-> (the 2-rank cases, the 4-rank cases, their inputs, the JAX side
    to run: {name: thunk -> {key: array}})."""
    from rtts.attention.full import attention_init
    from rtts.config import ReformerStackConfig as JS
    from rtts.models.stack import stack_apply as jstack
    from rtts.models.stack import stack_init
    from rtts.ops.flash_attention import dropout_seed_from_key
    from rtts.parallel.seq_parallel import (
        full_self_attention_seq_parallel as jfull,
        lsh_attention_seq_parallel as jlsh)

    rng = np.random.default_rng(11)
    f32 = np.float32
    two, four, inputs, jax_side = [], [], {}, {}

    # full attention, the sublayer: causal or not, the port's flash path
    # (K1/K3's plain versions at q_offset) and naive path, and dropout
    b, l, dm = 2, 64, 32
    x = rng.standard_normal((b, l, dm)).astype(f32)
    mask = np.arange(l)[None, :] < np.asarray([l, l - 9])[:, None]
    wt = rng.standard_normal((b, l, dm)).astype(f32)
    params = np_tree(attention_init(jax.random.PRNGKey(0), dm, 2, 16, True))
    seed = int(dropout_seed_from_key(jax.random.PRNGKey(SEQ_DROP_KEY)))
    for causal, rate in ((True, 0.0), (False, 0.0), (True, 0.3)):
        ref = f"full_{int(causal)}_{rate}"
        jcfg = _seq_attention_cfg("full", attention_dropout=rate)

        def run(causal=causal, rate=rate, jcfg=jcfg, x=x, mask=mask, wt=wt,
                params=params):
            def loss(p, xx):
                out = jfull(p, xx, jnp.asarray(mask), causal, jcfg,
                            mesh=_jmesh(1, 2), dropout_rate=rate,
                            dropout_rng=(jax.random.PRNGKey(SEQ_DROP_KEY)
                                         if rate else None))
                return (out * wt).sum(), out

            (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(params, x)
            return {"out": out, "g/x": gx, **_paths(gp, "g/")}

        jax_side[ref] = run
        for flash in (True, False):
            name = f"spa_{ref}_{flash}"
            two.append({"kind": "seq_attn", "name": name, "ref": ref,
                        "mp": 2, "causal": causal,
                        "attention": to_dict(dataclasses.replace(
                            jcfg, flash=flash)),
                        "seed": seed if rate else None})
            inputs.update({f"{name}/x": x, f"{name}/mask": mask,
                           f"{name}/wt": wt,
                           **_paths(params, f"{name}/p/")})

    # LSH attention, the core on each rank's rows: both exchanges x causal
    # or not, ragged masks (tests/test_seq_parallel.py's case at 2 ranks)
    b, h, l, d = 2, 2, 128, 16
    qk = rng.standard_normal((b, h, l, d)).astype(f32)
    v = rng.standard_normal((b, h, l, d)).astype(f32)
    wt = rng.standard_normal((b, h, l, d)).astype(f32)
    mask = np.arange(l)[None, :] < np.asarray([l, l - 40])[:, None]
    rot = np.asarray(jax.random.normal(jax.random.PRNGKey(7),
                                       (h, d, 2, 4), jnp.float32))
    lcfg = _seq_attention_cfg("lsh")
    for causal in (True, False):
        ref = f"lsh_{int(causal)}"

        def run(causal=causal, qk=qk, v=v, wt=wt, mask=mask, rot=rot):
            def loss(q, vv):
                out = jlsh(q, vv, lcfg, jnp.asarray(mask), causal,
                           jnp.asarray(rot), _jmesh(1, 2))
                return (out * wt).sum(), out

            (_, out), (gq, gv) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(qk, v)
            return {"out": out, "g/qk": gq, "g/v": gv}

        jax_side[ref] = run
        for exchange in ("allgather", "ring"):
            name = f"spa_{ref}_{exchange}"
            two.append({"kind": "seq_attn", "name": name, "ref": ref,
                        "mp": 2, "causal": causal, "exchange": exchange,
                        "attention": to_dict(lcfg)})
            inputs.update({f"{name}/qk": qk, f"{name}/v": v,
                           f"{name}/wt": wt, f"{name}/mask": mask,
                           f"{name}/rot": rot})

    def stack_case(name, ref, group, jcfg, pcfg, cross, mesh, n_rows=2,
                   l=128, dcn=1):
        """A ``stack`` rank case of ``pcfg`` (port) and its JAX run of
        ``jcfg`` on the (dcn, data, model) mesh ``(dcn, *mesh)``."""
        key = jax.random.PRNGKey(4)
        params = np_tree(stack_init(key, jcfg, cross_attend=cross))
        r = np.random.default_rng(sum(map(ord, ref)))
        data = {"x": r.standard_normal((n_rows, l, 32)).astype(f32),
                "mask": np.arange(l)[None, :] < np.asarray(
                    [l, l - 9, l, l - 3][:n_rows])[:, None],
                "wt": r.standard_normal((n_rows, l, 32)).astype(f32)}
        if cross:
            data["memory"] = r.standard_normal((n_rows, 48, 32)).astype(f32)
            data["memory_mask"] = np.arange(48)[None, :] < np.asarray(
                [48, 40, 48, 30][:n_rows])[:, None]
        if jcfg.attention.kind == "lsh":
            data["rot"] = np.asarray(jax.random.normal(
                jax.random.PRNGKey(SEQ_HASH_SEED), (2, 16, 2, 4),
                jnp.float32))
        group.append({"kind": "stack", "name": name, "ref": ref,
                      "stack": to_dict(pcfg), "dp": mesh[0], "mp": mesh[1],
                      "dcn": dcn})
        inputs.update({f"{name}/{k}": a for k, a in data.items()})
        inputs.update(_paths(params, f"{name}/p/"))
        if ref in jax_side:
            return

        def run():
            def loss(p, xx, mem):
                y = jstack(p, jcfg, xx, jnp.asarray(data["mask"]),
                           memory=mem,
                           memory_mask=(jnp.asarray(data["memory_mask"])
                                        if cross else None),
                           rng=jax.random.PRNGKey(5), deterministic=True)
                return (y * data["wt"]).sum(), y

            with _jmesh(*mesh, dcn=dcn):
                (_, y), (gp, gx, gm) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1, 2), has_aux=True))(
                        params, data["x"], data.get("memory"))
            out = {"y": y, "g/x": gx, **_paths(gp, "g/p/")}
            if cross:
                out["g/memory"] = gm
            return out

        jax_side[ref] = run

    # a stack under seq_parallel_axis (reversible; full, and LSH on both
    # exchanges) against JAX's sequence-parallel stack
    for kind in ("full", "lsh"):
        acfg = _seq_attention_cfg(kind, **({"hash_seed": SEQ_HASH_SEED}
                                           if kind == "lsh" else {}))
        base = JS(num_layers=2, d_model=32, d_ff=64, dropout=0.0,
                  reversible=True, causal=True, attention=acfg)
        sp = dataclasses.replace(base, seq_parallel_axis="model")
        for exchange in (("allgather", "ring") if kind == "lsh"
                         else ("allgather",)):
            cfg = dataclasses.replace(sp, seq_parallel_exchange=exchange)
            stack_case(f"sps_{kind}_{exchange}", f"sps_{kind}", two, sp,
                       cfg, False, (1, 2))

    # the same stacks split over the data axis of a (data 2, model 1)
    # mesh, each rank holding 2 of the 4 batch rows, against JAX's stack
    # on its (data 2, model 1) mesh (full attention has no exchange: both
    # sides ignore it)
    for kind in ("full", "lsh"):
        acfg = _seq_attention_cfg(kind, **({"hash_seed": SEQ_HASH_SEED}
                                           if kind == "lsh" else {}))
        sd = JS(num_layers=2, d_model=32, d_ff=64, dropout=0.0,
                reversible=True, causal=True, attention=acfg,
                seq_parallel_axis="data")
        for exchange in ("allgather", "ring"):
            stack_case(f"sds_{kind}_{exchange}", f"sds_{kind}", two, sd,
                       dataclasses.replace(sd, seq_parallel_exchange=exchange),
                       False, (2, 1), n_rows=4)
        # on the 4 ranks of a (dcn 2, data 2, model 1) mesh, one row each,
        # over the dcn axis and over the inner data axis
        for axis in ("dcn", "data"):
            sa = dataclasses.replace(sd, seq_parallel_axis=axis,
                                     seq_parallel_exchange="ring")
            stack_case(f"sd4_{kind}_{axis}", f"sd4_{kind}_{axis}", four, sa,
                       sa, False, (2, 1), n_rows=4, dcn=2)

    # pipelines (tests/test_pipeline_parallel.py's): full and LSH x cross
    # or not x interleave 1 and 2, remat on; remat off for the decoder at
    # both interleaves; data 2 x pipeline 2 on the 4 ranks
    for kind in ("full", "lsh"):
        acfg = _seq_attention_cfg(kind, **({"hash_seed": SEQ_HASH_SEED}
                                           if kind == "lsh" else {}))
        for cross in (False, True):
            base = JS(num_layers=4, d_model=32, d_ff=64, dropout=0.0,
                      reversible=False, causal=cross, attention=acfg)
            # JAX's interleaved pipeline is the reference of both
            # interleaves (the same function)
            ref = f"pp_{kind}_{int(cross)}"
            jpp = dataclasses.replace(base, pipeline_axis="model",
                                      pipeline_interleave=2,
                                      pipeline_microbatches=4)
            for v in (2, 1):
                pp = dataclasses.replace(base, pipeline_axis="model",
                                         pipeline_interleave=v,
                                         pipeline_microbatches=2 * v)
                remats = (True, False) if kind == "full" and cross \
                    else (True,)
                for remat in remats:
                    stack_case(f"{ref}_{v}_{int(remat)}", ref, two, jpp,
                               dataclasses.replace(pp, pipeline_remat=remat),
                               cross, (1, 2), n_rows=4, l=64)
    base = JS(num_layers=4, d_model=32, d_ff=64, dropout=0.0,
              reversible=False, causal=False,
              attention=_seq_attention_cfg("full"))
    pp = dataclasses.replace(base, pipeline_axis="model",
                             pipeline_microbatches=2)
    stack_case("pp_dp2", "pp_dp2", four, pp, pp, False, (2, 2), n_rows=4,
               l=64)
    return two, four, inputs, jax_side


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The rank cases of ``_seq_specs`` in a 2- and a 4-rank group, started
    before JAX's side compiles."""
    two, four, inputs, jax_side = _seq_specs()
    root = tmp_path_factory.mktemp("torch_parallel_seq")
    procs = {w: spawn(root / f"w{w}", w, cases, inputs)
             for w, cases in ((2, two), (4, four))}
    try:   # the JAX side compiles while the ranks run
        seq_out = {ref: run() for ref, run in jax_side.items()}
    finally:
        ranks = {w: collect(root / f"w{w}", p) for w, p in procs.items()}
    return dict(ranks=ranks, root=root, seq=seq_out,
                seq_cases={c["name"]: (w, c) for w, cs in
                           ((2, two), (4, four)) for c in cs})


SPA_NAMES = ([f"spa_full_{c}_{r}_{f}" for c, r in ((1, 0.0), (0, 0.0),
                                                    (1, 0.3))
              for f in (True, False)]
             + [f"spa_lsh_{c}_{e}" for c in (1, 0)
                for e in ("allgather", "ring")])
SPS_NAMES = ["sps_full_allgather", "sps_lsh_allgather", "sps_lsh_ring"]
SDS_NAMES = ([f"sds_{k}_{e}" for k in ("full", "lsh")
              for e in ("allgather", "ring")]
             + [f"sd4_{k}_{a}" for k in ("full", "lsh")
                for a in ("dcn", "data")])
PP_NAMES = ([f"pp_{k}_{x}_{v}_1" for k in ("full", "lsh") for x in (0, 1)
             for v in (1, 2)]
            + ["pp_full_1_1_0", "pp_full_1_2_0", "pp_dp2"])


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


def _seq_outputs(runs, name):
    """-> (each rank's outputs of case ``name``, the case, JAX's)."""
    w, case = runs["seq_cases"][name]
    return runs["ranks"][w], case, runs["seq"][case["ref"]]


@pytest.mark.parametrize("name", SPA_NAMES)
def test_seq_parallel_attention_matches_jax(runs, name):
    """Sequence-parallel attention at 2 ranks against JAX's at 2 devices:
    the full sublayer (K1/K3's plain versions at q_offset 0 and L/2, or the
    naive path; with the kernels' hash dropout) whole on both ranks with
    the gradients of x and the projections; the LSH core (both exchanges,
    ragged masks) on each rank's rows with the gradients of qk and v."""
    outs, case, want = _seq_outputs(runs, name)
    if name.startswith("spa_full"):
        for r, out in enumerate(outs):
            for k, v in want.items():
                tol = SEQ_TOL if k == "out" else SEQ_GRAD_TOL
                _close(out[f"{name}/{k}"], v, tol, f"rank {r} {k}")
        return
    for k, v in want.items():
        got = np.concatenate([out[f"{name}/{k}"] for out in outs], axis=2)
        _close(got, v, SEQ_TOL if k == "out" else SEQ_GRAD_TOL, k)


def _port_stack(runs, name, monkeypatch, seq_free):
    """One process of the port on case ``name``'s stack with its pipeline
    or sequence axis removed -> (y, {gradient name: array})."""
    from rtts_torch.attention import lsh as TL
    from rtts_torch.convert import load_flat
    from rtts_torch.models.stack import Stack, stack_apply

    _, case = runs["seq_cases"][name]
    cfg = dataclasses.replace(TC.from_dict(TC.ReformerStackConfig,
                                           case["stack"]), **seq_free)
    inputs = np.load(runs["root"] / "w2" / "inputs.npz")
    get = {k[len(name) + 1:]: inputs[k] for k in inputs.files
           if k.startswith(name + "/")}
    if "rot" in get:
        monkeypatch.setattr(TL, "draw_rotations",
                            lambda *a: tt(get["rot"]))
    stack = load_flat(Stack(cfg, "memory" in get, device="cpu"),
                      {k[2:].replace("/", "."): v for k, v in get.items()
                       if k.startswith("p/")})
    x = tt(get["x"]).requires_grad_()
    y = stack_apply(stack, cfg, x, tt(get["mask"]))
    (y * tt(get["wt"])).sum().backward()
    grads = {f"g/p/{n.replace('.', '/')}": p.grad.numpy()
             for n, p in stack.named_parameters()}
    return y.detach().numpy(), {"g/x": x.grad.numpy(), **grads}


@pytest.mark.parametrize("name", SPS_NAMES)
def test_seq_parallel_stack_matches_jax_and_one_process(runs, name,
                                                        monkeypatch):
    """A reversible stack with ``seq_parallel_axis`` (full; LSH on both
    exchanges) at 2 ranks: output and every gradient against JAX's
    sequence-parallel stack, and against the port's own one-process
    stack."""
    outs, case, want = _seq_outputs(runs, name)
    y1, g1 = _port_stack(runs, name, monkeypatch,
                         {"seq_parallel_axis": None})
    for r, out in enumerate(outs):
        _close(out[f"{name}/y"], want["y"], SEQ_TOL, f"rank {r} y")
        _close(out[f"{name}/y"], y1, SEQ_TOL, f"rank {r} y, one process")
        for k, v in want.items():
            if k != "y":
                _close(out[f"{name}/{k}"], v, SEQ_GRAD_TOL, f"rank {r} {k}")
                _close(out[f"{name}/{k}"], g1[k], SEQ_GRAD_TOL,
                       f"rank {r} {k}, one process")


@pytest.mark.parametrize("name", SDS_NAMES)
def test_data_axis_seq_parallel_stack_matches_jax_and_one_process(
        runs, name, monkeypatch):
    """A reversible stack with ``seq_parallel_axis: data`` (full; LSH on
    both exchanges) on a (data 2, model 1) mesh, each rank holding 2 of the
    4 rows, and with it split over the dcn axis and over the inner data
    axis of a (dcn 2, data 2, model 1) mesh, a row a rank: the output and
    the gradient of x (each rank's rows) and of every parameter (summed
    over the data group, as the trainer sums them) against JAX's stack on
    its mesh of the same layout and against the port's one-process stack
    on the whole batch."""
    outs, case, want = _seq_outputs(runs, name)
    y1, g1 = _port_stack(runs, name, monkeypatch,
                         {"seq_parallel_axis": None})
    dp = case["dcn"] * case["dp"]
    for k, v in want.items():
        tol = SEQ_TOL if k == "y" else SEQ_GRAD_TOL
        one = y1 if k == "y" else g1[k]
        if k.startswith("g/p/"):
            got = [outs[r][f"{name}/{k}"] for r in range(dp)]
        else:
            got = [np.concatenate([outs[r][f"{name}/{k}"]
                                   for r in range(dp)])]
        for r, g in enumerate(got):
            _close(g, v, tol, f"rank {r} {k}")
            _close(g, one, tol, f"rank {r} {k}, one process")


def test_pipeline_over_the_data_axis_is_refused():
    """The reference's pipeline over the data axis, which its batch rides
    too (``rtts/parallel/pipeline.py::_batch_axes``), does not give the
    one-device output on a (data 2, model 1) mesh (pinned here); the port
    refuses that layout, saying why."""
    from rtts.models.stack import stack_apply as jstack
    from rtts.models.stack import stack_init
    from rtts_torch.models.stack import Stack, stack_apply
    from rtts_torch.parallel.mesh import Mesh

    jcfg = dataclasses.replace(_refusal_cfgs("batch")[1], num_layers=4,
                               causal=False, pipeline_axis=None)
    params = stack_init(jax.random.PRNGKey(0), jcfg, cross_attend=False)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((4, 32, 32)).astype(np.float32))
    mask = jnp.arange(32)[None, :] < jnp.asarray([32, 23, 32, 29])[:, None]
    one = jstack(params, jcfg, x, mask, rng=jax.random.PRNGKey(5),
                 deterministic=True)
    pp = dataclasses.replace(jcfg, pipeline_axis="data",
                             pipeline_microbatches=2)
    with _jmesh(2, 1):
        got = jax.jit(lambda p, xx: jstack(
            p, pp, xx, mask, rng=jax.random.PRNGKey(5),
            deterministic=True))(params, x)
    assert float(jnp.max(jnp.abs(got - one))) > 1e-2
    tcfg = TC.from_dict(TC.ReformerStackConfig, to_dict(pp))
    stack = Stack(tcfg, False, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    view = Mesh(dcn=1, dp=2, mp=1, rank=0, data_index=0, model_index=0,
                data_ranks=[0, 1], model_ranks=[0])
    with pytest.raises(NotImplementedError, match="one-device"), view, \
            torch.no_grad():
        stack_apply(stack, tcfg, tt(np.asarray(x)), tt(np.asarray(mask)))


@pytest.mark.parametrize("name", PP_NAMES)
def test_pipeline_matches_jax(runs, name):
    """A pipelined stack (pp_KIND_CROSS_V_REMAT: full or LSH, with the
    decoder's cross-attention or not, interleave 1 or 2, remat on or off;
    pp_dp2: data 2 x pipeline 2 on 4 ranks) against JAX's pipeline on its
    mesh (interleave 2 for both interleaves): the output, the gradients of x and the memory (each data rank's
    rows) and of every parameter (summed over the data group), on every
    rank."""
    outs, case, want = _seq_outputs(runs, name)
    mp = case["mp"]
    for k, v in want.items():
        tol = SEQ_TOL if k == "y" else SEQ_GRAD_TOL
        for j in range(mp):   # each model rank holds the whole of it
            got = outs[j][f"{name}/{k}"]
            if not k.startswith("g/p/"):
                got = np.concatenate([outs[i * mp + j][f"{name}/{k}"]
                                      for i in range(case["dp"])])
            _close(got, v, tol, f"model rank {j} {k}")


def test_rank_flash_keep_bits_are_the_global_masks_slice():
    """A sequence-parallel rank's K1/K3 dropout draws keep bits at its
    ``q_offset``: bit for bit JAX's ``dropout_keep_mask`` rows, and JAX's
    own at that offset."""
    seed, rate, bh, l = 987654321, 0.3, 6, 64
    whole = np.asarray(jax_keep_mask(seed, bh, l, l, rate))
    from rtts.ops.flash_attention import dropout_keep_mask as jkm

    for off in (0, 24, 32):
        got = dropout_keep_mask(seed, bh, 32, l, rate, q_offset=off).numpy()
        np.testing.assert_array_equal(got, whole[:, off:off + 32])
        np.testing.assert_array_equal(
            got, np.asarray(jkm(seed, bh, 32, l, rate, q_offset=off)))


def test_lsh_window_dropout_lanes_equal_jax():
    """``_attend_window`` keys its dropout on the global chunk: the lanes
    of chunks lo.. equal JAX's ``dropout_lane``, and the windowed attend
    with dropout equals JAX's ``_attend_window`` (1e-5)."""
    from rtts.attention.lsh import dropout_lane as jlane
    from rtts.parallel.seq_parallel import _attend_window as jwin
    from rtts_torch.ops.lsh_attention import dropout_lane
    from rtts_torch.parallel.seq_parallel import _attend_window

    rng = np.random.default_rng(3)
    b, h, ncl, c, d, lo, cpr = 2, 2, 3, 8, 16, 5, 4
    np.testing.assert_array_equal(
        dropout_lane(b, h, lo + torch.arange(ncl), cpr).numpy(),
        np.asarray(jlane(b, h, lo + jnp.arange(ncl), cpr)))
    q = rng.standard_normal((b, h, ncl, c, d)).astype(np.float32)
    k = rng.standard_normal((b, h, ncl + 1, c, d)).astype(np.float32)
    v = rng.standard_normal((b, h, ncl + 1, c, d)).astype(np.float32)
    pos = rng.permutation(64)[:(ncl + 1) * c].reshape(ncl + 1, c)
    pos_k = np.broadcast_to(pos, (b, h, ncl + 1, c)).astype(np.int32)
    pos_q = pos_k[:, :, 1:]
    val = rng.random((b, h, ncl + 1, c)) > 0.2
    args = (True, 1, 0, -1e9, -1e5)
    want = jwin(q, k, v, pos_q, pos_k, val, *args, dropout_rate=0.4,
                dropout_seed=jnp.uint32(77), chunk_lo=lo,
                chunks_per_round=cpr)
    got = _attend_window(tt(q), tt(k), tt(v), tt(pos_q).long(),
                         tt(pos_k).long(), tt(val), *args, dropout_rate=0.4,
                         dropout_seed=77, chunk_lo=lo, chunks_per_round=cpr)
    for g, w in zip(got, want):
        _close(g.numpy(), w, SEQ_TOL, "attend window")


def _one_rank_pipeline(rate, micro=2):
    from rtts_torch.models.stack import Stack, stack_apply
    from rtts_torch.parallel.mesh import make_mesh

    acfg = TC.AttentionConfig(kind="full", num_heads=2, head_dim=16)
    base = TC.ReformerStackConfig(num_layers=2, d_model=32, d_ff=64,
                                  dropout=rate, reversible=False,
                                  attention=acfg)
    pp = dataclasses.replace(base, pipeline_axis="model",
                             pipeline_microbatches=micro)
    stack = Stack(base, False, generator=torch.Generator().manual_seed(1),
                  device="cpu")
    x = torch.randn(2, 4, 16, 32, generator=torch.Generator().manual_seed(2))
    x = x[:1].expand(2, 4, 16, 32).reshape(8, 16, 32)  # twin microbatches

    def run(cfg, seed):
        with torch.no_grad(), make_mesh():
            return stack_apply(stack, cfg, x, None,
                               generator=torch.Generator().manual_seed(seed))

    return run, base, pp


def test_pipeline_microbatches_draw_their_own_masks():
    """Two microbatches of equal rows: under dropout they draw different
    masks (their outputs differ), the same ones again from the same
    generator; at dropout 0 the pipeline's output is the sequential
    path's in train mode."""
    run, base, pp = _one_rank_pipeline(0.5)
    y = run(pp, 3)
    assert not torch.equal(y[:4], y[4:])
    assert torch.equal(y, run(pp, 3))
    run, base, pp = _one_rank_pipeline(0.0)
    torch.testing.assert_close(run(pp, 3), run(base, 3), atol=1e-6,
                               rtol=1e-6)


def _refusal_cfgs(case):
    """-> (port stack config, JAX stack config, L, batch, cross, sink,
    enter the mesh) of one refusal case."""
    from rtts.config import ReformerStackConfig as JS

    full = _seq_attention_cfg("full")
    kw = dict(num_layers=2, d_model=32, d_ff=64, dropout=0.0,
              reversible=False, causal=True, attention=full)
    pipe = {"pipeline_axis": "model"}
    l, b, cross, sink, enter = 32, 2, False, False, True
    if case == "seq_and_pipe":
        kw.update(pipe, seq_parallel_axis="model")
    elif case == "reversible":
        kw.update(pipe, reversible=True)
    elif case == "kinds":
        kw.update(pipe, attn_layers=["full", "lsh"])
    elif case == "stages":
        kw.update(pipe, num_layers=3)
    elif case == "interleave":
        kw.update(pipe, pipeline_interleave=2)
    elif case == "micro":
        kw.update(pipe, num_layers=4, pipeline_interleave=2,
                  pipeline_microbatches=3)
    elif case == "batch":
        kw.update(pipe)
        b = 3
    elif case == "guided":
        kw.update(pipe)
        cross = sink = True
    elif case == "pipe_no_mesh":
        kw.update(pipe)
        enter = False
    elif case == "seq_no_mesh":
        kw.update(seq_parallel_axis="model")
        enter = False
    elif case == "seq_len":
        kw.update(seq_parallel_axis="model")
        l = 35
    elif case == "lsh_chunks":
        kw.update(seq_parallel_axis="model",
                  attention=dataclasses.replace(_seq_attention_cfg("lsh"),
                                                num_hashes=1))
        l = 48
    elif case == "exchange":
        kw.update(seq_parallel_axis="model", seq_parallel_exchange="tree",
                  attention=_seq_attention_cfg("lsh"))
        l = 64
    elif case == "guided_reversible":
        kw.update(reversible=True)
        cross = sink = True
    jcfg = JS(**kw)
    return (TC.from_dict(TC.ReformerStackConfig, to_dict(jcfg)), jcfg, l, b,
            cross, sink, enter)


REFUSALS = ["seq_and_pipe", "reversible", "kinds", "stages", "interleave",
            "micro", "batch", "guided", "pipe_no_mesh", "seq_no_mesh",
            "seq_len", "lsh_chunks", "exchange", "guided_reversible"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_match_the_reference(case):
    """Every refusal of the reference's pipeline and sequence-parallel
    paths: the port raises its ValueError under the same condition as JAX
    (model axis of 2; the port's view of rank 0, whose checks all come
    before its first collective)."""
    from rtts.models.stack import stack_apply as jstack
    from rtts.models.stack import stack_init
    from rtts_torch.models.stack import Stack, stack_apply
    from rtts_torch.parallel.mesh import Mesh

    tcfg, jcfg, l, b, cross, sink, enter = _refusal_cfgs(case)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, l, 32)).astype(np.float32)
    mem = rng.standard_normal((b, 8, 32)).astype(np.float32) if cross \
        else None
    params = stack_init(jax.random.PRNGKey(0), jcfg, cross_attend=cross)
    mesh = _jmesh(1, 2) if enter else contextlib.nullcontext()
    with pytest.raises(ValueError) as want, mesh:
        jstack(params, jcfg, jnp.asarray(x), None,
               memory=None if mem is None else jnp.asarray(mem),
               rng=jax.random.PRNGKey(1), deterministic=True,
               attn_sink=[] if sink else None)
    port_mesh = Mesh(dcn=1, dp=1, mp=2, rank=0, data_index=0, model_index=0,
                     data_ranks=[0], model_ranks=[0, 1])
    stack = Stack(tcfg, cross, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    with pytest.raises(ValueError) as got, \
            (port_mesh if enter else contextlib.nullcontext()), \
            torch.no_grad():
        stack_apply(stack, tcfg, tt(x), None,
                    memory=None if mem is None else tt(mem),
                    attn_sink=[] if sink else None)
    head = str(want.value).split("(")[0].split(";")[0][:40]
    assert str(got.value).startswith(head), (str(got.value),
                                             str(want.value))
