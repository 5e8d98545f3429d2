"""PyTorch port, the dry run against the JAX package's.

* In one subprocess (it owns a fake process group of 8 ranks), reduced
  cells of a dense, an MoE (MLA, shared experts), a Mamba-2 and the audio
  arch, and a sliding-window MoE at ``long_500k``, at the published shapes
  on a fake (2, 4) ``DeviceMesh``: ``ok`` records with every key, whose
  ``argument_bytes_per_device`` equal the shard bytes of the reference's
  ``NamedSharding``s on an ``AbstractMesh`` of that shape (the reference's
  per-layer cache ``index`` scalars aside: the port's cache keeps its
  position once, as ``pos``).
* On a 1 x 1 mesh one card's counts equal a trace of the global step
  through the port's entry points.
* ``_probe_costs``' extrapolation equals a full trace at a reduced depth:
  FLOPs and bytes (sums over the ops) to 1e-9; the temp bytes, a peak, to
  1e-4 or 64 bytes: an inference pass's peak lies within one layer and is
  flat in depth from 3 layers on, but the 2-layer probe holds one float32
  scalar less, so deepseek's prefill and decode at 10 layers read 28 bytes
  over (of 2.2 MB and 73 kB; at 8 layers 20 bytes).
* The FLOPs of a reduced train and prefill step against the reference's
  ``jax.jit(...).lower(...).compile().cost_analysis()["flops"]``: the
  reference counts elementwise work too (a few per cent at these widths),
  so the bar is 0.15 relative, and the same count with one layer dropped
  reads 0.32-0.67 over it.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
import repro.distributed.sharding as jsh
import repro.models.model as jmodel
import repro.train.optimizer as jopt
import repro.train.train_step as jtrain
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.distributed.sharding import MeshShape, make_rules
from repro_torch.launch import dryrun
from repro_torch.models import LM, forward_decode, forward_prefill
from repro_torch.models.model import _new_cache
from repro_torch.train import TrainConfig, init_opt_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("qwen2.5-3b", "train_4k"), ("qwen2.5-3b", "decode_32k"),
         ("deepseek-v2-lite-16b", "train_4k"), ("deepseek-v2-lite-16b", "prefill_32k"),
         ("mamba2-2.7b", "train_4k"), ("mamba2-2.7b", "long_500k"),
         ("whisper-base", "train_4k"), ("whisper-base", "decode_32k"),
         ("mixtral-8x7b", "long_500k")]
FLOPS_TOL = 0.15

_SUBPROC = r"""
import dataclasses, json, sys
from pathlib import Path
sys.path.insert(0, "src")
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
try:
    make_production_mesh()
    raise SystemExit("a 16x16 mesh over 8 ranks")
except RuntimeError as e:
    assert "needs 256" in str(e), e
mesh = make_host_mesh(2, 4)
out = Path(sys.argv[1])
recs = []
for arch, shape in json.loads(sys.argv[2]):
    cfg = get_config(arch).reduced()
    recs.append(run_cell(arch, shape, False, out, mesh=mesh,
                         cfg_override=dataclasses.asdict(cfg)))
(out / "records.json").write_text(json.dumps(recs))
print("SUBPROCESS_OK")
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    r = subprocess.run([sys.executable, "-c", _SUBPROC, str(out), json.dumps(CELLS)],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert "SUBPROCESS_OK" in r.stdout, r.stdout[-3000:] + "\n" + r.stderr[-3000:]
    return {(rec["arch"], rec["shape"]): rec
            for rec in json.loads((out / "records.json").read_text())}


def _reference_dryrun():
    """``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported: initialise
    the backend first and restore the variable."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdry


def _bytes(structs, shardings) -> int:
    leaves = jax.tree_util.tree_flatten_with_path(structs)[0]
    shs = jax.tree.leaves(shardings)
    assert len(leaves) == len(shs)
    return sum(math.prod(sh.shard_shape(s.shape)) * s.dtype.itemsize
               for (path, s), sh in zip(leaves, shs)
               if not path or getattr(path[-1], "key", None) != "index")


def _reference_argument_bytes(arch, shape_name) -> int:
    jdry = _reference_dryrun()
    jcfg = jconfigs.get_config(arch).reduced()
    shape = jconfigs.SHAPES[shape_name]
    mesh = AbstractMesh((2, 4), ("data", "model"))
    rules = jsh.make_rules(jcfg)
    if shape_name == "long_500k":
        rules["kv_seq"] = "model"
    specs = jmodel.param_specs(jcfg)
    p_structs = jsh.spec_struct(specs)
    p_sh = jsh.tree_shardings(specs, mesh, rules, fsdp=jcfg.fsdp)
    total = _bytes(p_structs, p_sh)
    B, S = shape.global_batch, shape.seq_len
    bsh = jdry._batch_sharding(mesh, B, rules)
    if shape.kind == "train":
        opt_cfg = jdry.opt_config_for(jcfg)
        o_structs = jax.eval_shape(lambda p: jopt.init_opt_state(p, opt_cfg), p_structs)
        o_sh = jdry.opt_shardings(o_structs, p_sh, mesh, p_specs=specs, rules=rules,
                                  fsdp=jcfg.fsdp)
        b_structs, b_sh = jdry.batch_specs(jcfg, shape, mesh, rules)
        return total + _bytes(o_structs, o_sh) + _bytes(b_structs, b_sh)
    if shape.kind == "prefill":
        total += _bytes(jax.ShapeDtypeStruct((B, S), jnp.int32), bsh)
        extras = jdry._extras_structs(jcfg, B, mesh, bsh)
        return total + (_bytes(*extras) if extras else 0)
    c_specs = jmodel.cache_specs(jcfg, B, S)
    return (total + _bytes(jax.ShapeDtypeStruct((B, 1), jnp.int32), bsh)
            + _bytes(jsh.spec_struct(c_specs), jsh.tree_shardings(c_specs, mesh, rules)))


KEYS = {"arch", "shape", "mesh", "chips", "kind", "tag", "ok", "cost_source",
        "trace_s", "memory", "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "temp_bytes_per_device", "argument_bytes_per_device"}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_reduced_cell_on_a_fake_mesh(records, arch, shape):
    rec = records[(arch, shape)]
    assert rec["ok"], rec.get("traceback")
    assert set(rec) == KEYS and set(rec["memory"]) == MEMORY_KEYS
    assert (rec["mesh"], rec["chips"]) == ("2x4", 8)
    roof = rec["roofline"]
    assert roof["hlo_flops"] > 0 and roof["hlo_bytes"] > 0 and roof["model_flops"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert set(roof["collective_detail"]) == {"all-gather", "all-reduce", "reduce-scatter",
                                              "all-to-all", "collective-permute", "counts"}
    mem = rec["memory"]
    for key in ("argument", "temp"):
        assert mem[f"{key}_bytes"] == mem[f"{key}_bytes_per_device"] * 8
    assert mem["argument_bytes_per_device"] == _reference_argument_bytes(arch, shape)
    if shape == "long_500k" and arch == "mixtral-8x7b":
        # the context-parallel exchange of every attention layer
        assert roof["collective_detail"]["counts"]["all-gather"] >= 2
    if arch == "deepseek-v2-lite-16b":   # 4 experts on 4 cards: the all-to-alls
        assert roof["collective_detail"]["all-to-all"] > 0


def _global_step(cfg, kind, B, S):
    """The global step through the port's entry points, on fake tensors."""
    model = LM(cfg, "cpu")
    extras = {k: torch.empty(s) for k, (s, _) in dryrun._extras_specs(cfg, B).items()}
    if kind == "train":
        opt = dryrun.opt_config_for(cfg)
        model.requires_grad_(True)
        state = init_opt_state(model, opt)
        batch = {"tokens": torch.zeros(B, S, dtype=torch.int32),
                 "labels": torch.zeros(B, S, dtype=torch.int32), **extras}
        return lambda: make_train_step(cfg, opt, TrainConfig())(model, state, batch)
    if kind == "prefill":
        tokens = torch.zeros(B, S, dtype=torch.int32)
        return lambda: forward_prefill(model, tokens, cfg, extras or None)
    slots = dryrun._slots(cfg, S)
    cache = {"layers": _new_cache(cfg, B, slots, "cpu"), "pos": slots - 1, "enc_kv": None}
    if cfg.encoder_layers:
        enc = (B, cfg.encoder_seq, cfg.num_heads, cfg.hd)
        cache["enc_kv"] = [(torch.zeros(enc), torch.zeros(enc))
                           for _ in range(cfg.num_layers)]
    token = torch.zeros(B, 1, dtype=torch.int32)
    return lambda: forward_decode(model, token, cache, cfg)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b", "mamba2-2.7b",
                                  "whisper-base"])
def test_one_card_mesh_equals_the_global_trace(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch).reduced()
    mesh = MeshShape(("data", "model"), (1, 1))
    B, S = 2, 64
    for kind in ("train", "prefill", "decode"):
        got = dryrun.trace_step(cfg, ShapeSpec("t", S, B, kind), mesh, make_rules(cfg))
        with FakeTensorMode():
            want = dryrun.count_ops(_global_step(cfg, kind, B, S))
        assert got == want, (kind, got, want)
        assert got["flops"] > 0 and got["bytes accessed"] > 0 and got["temp_bytes"] > 0
        coll = dryrun.count_collectives(cfg, ShapeSpec("t", S, B, kind), mesh,
                                        make_rules(cfg))
        assert sum(coll[k] for k in coll if k != "counts") == 0   # one card: none


@pytest.mark.parametrize("arch,layers", [("qwen2.5-3b", 8), ("deepseek-v2-lite-16b", 8)])
def test_probe_extrapolation_equals_a_full_trace(arch, layers):
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=layers)
    mesh = MeshShape(("data", "model"), (2, 4))
    rules = make_rules(cfg)
    for kind in ("train", "decode"):
        shape = ShapeSpec("t", 64, 4, kind)
        probed = dryrun._probe_costs(cfg, shape, mesh, rules)
        full = dryrun.trace_step(cfg, shape, mesh, rules)
        assert probed is not None and set(probed) == set(full)
        for k, v in full.items():
            tol = 1e-9 * abs(v) if k != "temp_bytes" else max(1e-4 * abs(v), 64)
            assert abs(probed[k] - v) <= tol, (kind, k, probed[k], v)


def _reference_flops(jcfg, kind, B, S) -> float:
    p = jsh.spec_struct(jmodel.param_specs(jcfg))
    tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if kind == "train":
        opt = jopt.OptConfig()
        o = jax.eval_shape(lambda p: jopt.init_opt_state(p, opt), p)
        step = jtrain.make_train_step(jcfg, opt, jtrain.TrainConfig())
        lowered = jax.jit(step).lower(p, o, {"tokens": tokens, "labels": tokens})
    else:
        lowered = jax.jit(lambda p, t: jmodel.forward_prefill(p, t, jcfg)).lower(p, tokens)
    cost = lowered.compile().cost_analysis()
    return float((cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b"])
def test_flops_against_the_reference_cost_analysis(arch):
    cfg, jcfg = get_config(arch).reduced(), jconfigs.get_config(arch).reduced()
    mesh = MeshShape(("data", "model"), (1, 1))
    B, S = 2, 64
    for kind in ("train", "prefill"):
        want = _reference_flops(jcfg, kind, B, S)
        shape = ShapeSpec("t", S, B, kind)
        got = dryrun.trace_step(cfg, shape, mesh, make_rules(cfg))["flops"]
        short = dataclasses.replace(cfg, num_layers=cfg.num_layers - 1)
        fault = dryrun.trace_step(short, shape, mesh, make_rules(short))["flops"]
        assert abs(got - want) / want < FLOPS_TOL, (kind, got, want)
        assert abs(fault - want) / want > 2 * FLOPS_TOL, (kind, fault, want)
