"""One rank of the port's multi-process CPU tests
(``tests/test_torch_parallel*.py``).

Run as ``python tests/torch_parallel_ranks.py WORKDIR RANK WORLD``.  JAX and
the JAX package are blocked before anything is imported: a rank runs the
port alone.  The parent test writes ``WORKDIR/spec.json`` (the cases) and
``WORKDIR/inputs.npz`` (parameters and data, made by the JAX package and
handed down as numpy); the ranks meet through a ``file://`` store in
WORKDIR over gloo, run every case in order, and each writes
``WORKDIR/rank{RANK}.npz``.  Case kinds:

- ``train``: ``steps`` train steps over a (data, model) mesh through
  ``MeshTraining`` (with ``k6``, every FFN through K6's wrapper) -> each
  step's metrics, the gathered tree after the last step (params and
  optimizer state under the checkpoint's leaf names), and rank 0 writes it
  as a checkpoint under WORKDIR/ckpt_<name>;
- ``decode``: ``decode_greedy`` of given encoder memory on tensor-parallel
  weights, with given LSH rotations for every head;
- ``synth``: ``Synthesizer(mesh=...).text_to_mel``;
- ``export``: ``export_synthesizer`` of a ``Synthesizer(mesh=...)``
  (gathered to whole weights; rank 0 writes WORKDIR/export_<name>) -> the
  manifest's artifact names, and whether ``gather_sharded=False`` was
  refused naming that option;
- ``serve_batch``: ``serve_batch`` on tensor-parallel weights;
- ``seq_attn``: sequence-parallel attention on the model group, the full
  sublayer (its output and the gradients of x and the projections) or the
  LSH core on the rank's rows (its rows of the output and of the
  gradients of qk and v), for the loss sum(out * wt);
- ``stack``: ``stack_apply`` of a stack with ``seq_parallel_axis`` or
  ``pipeline_axis`` over a (data, model) mesh, a data rank on its batch
  rows: its rows of the output and of the gradients of x and the memory,
  and every parameter's gradient summed over the data group, for the loss
  sum(y * wt).  LSH layers hash with the given rotations.
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.modules["jax"] = None       # any `import jax` now raises ImportError
sys.modules["rtts"] = None      # and so does any `import rtts...`
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from rtts_torch import config as TC  # noqa: E402
from rtts_torch.attention import lsh as TL  # noqa: E402
from rtts_torch.convert import load_flat  # noqa: E402
from rtts_torch.infer import draws  # noqa: E402
from rtts_torch.infer.decode import decode_greedy  # noqa: E402
from rtts_torch.infer.serving import serve_batch  # noqa: E402
from rtts_torch.infer.synthesize import Synthesizer  # noqa: E402
from rtts_torch.models import reformer_tts as TM  # noqa: E402
from rtts_torch.attention.full import Attention  # noqa: E402
from rtts_torch.models.stack import Stack, stack_apply  # noqa: E402
from rtts_torch.parallel.collectives import (all_reduce_flat,  # noqa: E402
                                             batch_shard)
from rtts_torch.parallel.seq_parallel import (  # noqa: E402
    full_self_attention_seq_parallel, lsh_attention_seq_parallel)
from rtts_torch.parallel.mesh import (initialize_distributed,  # noqa: E402
                                      make_mesh)
from rtts_torch.parallel.serving import shard_for_serving  # noqa: E402
from rtts_torch.parallel.sharding import whole_stacks  # noqa: E402
from rtts_torch.parallel.training import MeshTraining  # noqa: E402
from rtts_torch.train.checkpoint import write_checkpoint  # noqa: E402
from rtts_torch.train.optim import make_optimizer  # noqa: E402
from rtts_torch.train.train_tts import (make_train_step,  # noqa: E402
                                        step_generator)


def _model(case, inputs):
    cfg = TC.from_dict(TC.ReformerTTSConfig, case["model"])
    prefix = case["params"] + "/"
    leaves = {k[len(prefix):].replace("/", "."): v for k, v in inputs.items()
              if k.startswith(prefix)}
    return cfg, load_flat(TM.init(cfg, device="cpu"), leaves)


def _mesh(case):
    return make_mesh(TC.MeshConfig(data_parallel=case.get("dp", 1),
                                   model_parallel=case.get("mp", 1),
                                   dcn_parallel=case.get("dcn", 1)))


def run_train(case, inputs, work, rank):
    cfg, model = _model(case, inputs)
    if case.get("k6"):
        # K6's differentiable wrapper (its plain version on the CPU) on
        # every FFN, as the card runs it with use_pallas_ffn
        import dataclasses

        from rtts_torch.models import stack

        stack.use_ffn_kernel = lambda x: True
        cfg = dataclasses.replace(cfg, **{
            name: dataclasses.replace(getattr(cfg, name), use_pallas_ffn=True)
            for name in ("encoder", "decoder")})
    mesh = _mesh(case)
    optimizer = make_optimizer(TC.from_dict(TC.OptimConfig, case["optim"]))
    if f"{case['name']}/rot" in inputs:
        _inject_rotations(inputs[f"{case['name']}/rot"])
    par = MeshTraining(model, mesh, zero=case.get("zero", False),
                       tensor_parallel=mesh.model_size > 1,
                       whole=whole_stacks(cfg))
    state = par.init_state(optimizer, model)
    step_fn = make_train_step(cfg, optimizer, mesh=par)
    out = {}
    name = case["name"]
    for step in range(case["steps"]):
        keys = ("tokens", "token_mask", "mel", "mel_mask")
        batch = {k: inputs[f"{case['batches']}/{step}/{k}"] for k in keys}
        local, (off, total) = par.shard(batch)
        local = {k: torch.from_numpy(np.array(v)) for k, v in local.items()}
        local["tokens"] = local["tokens"].long()
        with batch_shard(off, total, mesh.data_group):
            metrics = step_fn(model, state, local,
                              step_generator(0, step, "cpu"), step)
        for k, v in metrics.items():
            out[f"{name}/metric/{step}/{k}"] = np.asarray(float(v))
    flat = par.snapshot(model, state)
    out.update({f"{name}/flat/{k}": v for k, v in flat.items()})
    if rank == 0:
        write_checkpoint(work / f"ckpt_{name}", flat, case["steps"])
    return out


def run_decode(case, inputs, work, rank):
    cfg, model = _model(case, inputs)
    mesh = _mesh(case)
    shard_for_serving(model, mesh)
    rots = [inputs[f"{case['name']}/rot/{i}"]
            for i in range(cfg.decoder.num_layers)]
    calls = []

    def draw(h, d, n_hashes, half, generator, device):
        calls.append(h)
        return torch.from_numpy(rots[(len(calls) - 1) % len(rots)])

    draws.draw_rotations = draw
    res = decode_greedy(model, cfg,
                        torch.from_numpy(inputs[f"{case['name']}/memory"]),
                        torch.from_numpy(inputs[f"{case['name']}/mask"]),
                        max_frames=case["max_frames"], mode=case["mode"],
                        stop_threshold=case.get("stop_threshold"))
    n = case["name"]
    return {f"{n}/mel": res.mel_post.numpy(),
            f"{n}/lengths": res.lengths.numpy(),
            f"{n}/stop_logits": res.stop_logits.numpy(),
            f"{n}/draws": np.asarray(calls)}


def run_synth(case, inputs, work, rank):
    cfg = TC.from_dict(TC.Config, case["config"])
    model = load_flat(TM.init(cfg.model, device="cpu"), {
        k[len(case["params"]) + 1:].replace("/", "."): v
        for k, v in inputs.items() if k.startswith(case["params"] + "/")})
    syn = Synthesizer(cfg, model, max_frames=case["max_frames"],
                      mesh=_mesh(case))
    mel, lengths = syn.text_to_mel(case["texts"])
    return {f"{case['name']}/mel": mel, f"{case['name']}/lengths": lengths}


def run_export(case, inputs, work, rank):
    from rtts_torch.infer.export import export_synthesizer

    cfg = TC.from_dict(TC.Config, case["config"])
    model = load_flat(TM.init(cfg.model, device="cpu"), {
        k[len(case["params"]) + 1:].replace("/", "."): v
        for k, v in inputs.items() if k.startswith(case["params"] + "/")})
    syn = Synthesizer(cfg, model, max_frames=case["max_frames"],
                      mesh=_mesh(case))
    n = case["name"]
    manifest = export_synthesizer(syn, str(work / f"export_{n}"),
                                  batch_sizes=case["batch_sizes"],
                                  token_len=case["token_len"])
    try:
        export_synthesizer(syn, str(work / f"refused_{n}"),
                           gather_sharded=False)
        refused = False
    except ValueError as e:
        refused = "gather_sharded" in str(e)
    return {f"{n}/artifacts": np.asarray(sorted(manifest["artifacts"])),
            f"{n}/refused": np.asarray(refused)}


def run_serve_batch(case, inputs, work, rank):
    cfg, model = _model(case, inputs)
    shard_for_serving(model, _mesh(case))
    n = case["name"]
    mel, lengths = serve_batch(
        model, cfg, torch.from_numpy(inputs[f"{n}/tokens"]),
        torch.from_numpy(inputs[f"{n}/mask"]),
        torch.from_numpy(inputs[f"{n}/budgets"]),
        capacity_frames=case["capacity"], slots=case["slots"],
        segment_frames=case["segment"], stop_threshold=2.0)
    return {f"{n}/mel": mel.numpy(), f"{n}/lengths": lengths.numpy()}


def _inject_rotations(rot: np.ndarray) -> None:
    """Every LSH draw returns ``rot`` (JAX's rotations of the hash seed)."""
    TL.draw_rotations = (lambda h, d, n_hashes, half, generator, device:
                         torch.from_numpy(rot).to(device))


def _leaves(inputs, prefix):
    return {k[len(prefix):].replace("/", "."): v for k, v in inputs.items()
            if k.startswith(prefix)}


def run_seq_attn(case, inputs, work, rank):
    n = case["name"]
    mesh = _mesh(case)
    acfg = TC.from_dict(TC.AttentionConfig, case["attention"])
    t = {k[len(n) + 1:]: torch.from_numpy(np.array(v))
         for k, v in inputs.items() if k.startswith(n + "/")}
    mask = t["mask"]
    if acfg.kind == "full":
        d_model = t["x"].shape[-1]
        attn = Attention(d_model, acfg.num_heads, acfg.head_dim, True,
                         device="cpu")
        load_flat(attn, _leaves(inputs, f"{n}/p/"))
        x = t["x"].requires_grad_()
        with mesh:
            out = full_self_attention_seq_parallel(
                attn, x, mask, case["causal"], acfg,
                dropout_rate=acfg.attention_dropout,
                dropout_seed=case.get("seed"))
        (out * t["wt"]).sum().backward()
        res = {"out": out, "g/x": x.grad}
        res.update({f"g/{k}/w": getattr(attn, k).w.grad
                    for k in ("w_qk", "w_v", "w_o")})
    else:
        shard = t["qk"].shape[2] // mesh.model_size
        rows = slice(mesh.model_index * shard, (mesh.model_index + 1) * shard)
        qk = t["qk"][:, :, rows].clone().requires_grad_()
        v = t["v"][:, :, rows].clone().requires_grad_()
        with mesh:
            out = lsh_attention_seq_parallel(
                qk, v, acfg, mask, case["causal"], t["rot"],
                exchange=case["exchange"])
        (out * t["wt"][:, :, rows]).sum().backward()
        res = {"out": out, "g/qk": qk.grad, "g/v": v.grad}
    return {f"{n}/{k}": v.detach().numpy() for k, v in res.items()}


def run_stack(case, inputs, work, rank):
    n = case["name"]
    mesh = _mesh(case)
    cfg = TC.from_dict(TC.ReformerStackConfig, case["stack"])
    cross = f"{n}/memory" in inputs
    stack = load_flat(Stack(cfg, cross, device="cpu"),
                      _leaves(inputs, f"{n}/p/"))
    if f"{n}/rot" in inputs:
        _inject_rotations(inputs[f"{n}/rot"])
    t = {k: torch.from_numpy(np.array(inputs[f"{n}/{k}"]))
         for k in ("x", "mask", "wt", "memory", "memory_mask")
         if f"{n}/{k}" in inputs}
    total = t["x"].shape[0]
    b = total // mesh.data_size
    off = mesh.data_index * b
    t = {k: v[off:off + b] for k, v in t.items()}
    x = t["x"].requires_grad_()
    mem = t["memory"].requires_grad_() if cross else None
    with mesh, batch_shard(off, total, mesh.data_group):
        y = stack_apply(stack, cfg, x, t["mask"], mem, t.get("memory_mask"))
    (y * t["wt"]).sum().backward()
    grads = [p.grad for p in stack.parameters()]
    all_reduce_flat(grads, mesh.data_group)
    res = {f"{n}/y": y, f"{n}/g/x": x.grad}
    if cross:
        res[f"{n}/g/memory"] = mem.grad
    for (name, _), g in zip(stack.named_parameters(), grads):
        res[f"{n}/g/p/{name.replace('.', '/')}"] = g
    return {k: v.detach().numpy() for k, v in res.items()}


CASES = {"train": run_train, "decode": run_decode, "synth": run_synth,
         "export": run_export, "serve_batch": run_serve_batch,
         "seq_attn": run_seq_attn, "stack": run_stack}


def main(work: pathlib.Path, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    spec = json.loads((work / "spec.json").read_text())
    with np.load(work / "inputs.npz") as z:
        inputs = {k: z[k] for k in z.files}
    initialize_distributed(TC.MeshConfig(
        coordinator_address=f"file://{work / 'store'}", num_processes=world,
        process_id=rank), device="cpu")
    out = {}
    for case in spec["cases"]:
        out.update(CASES[case["kind"]](case, inputs, work, rank))
    out["blocked"] = np.asarray(not any(
        m.split(".")[0] in ("jax", "rtts") for m in sys.modules
        if sys.modules[m] is not None))
    np.savez(work / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(pathlib.Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
