"""PyTorch port, the logical-axis sharding rules against the JAX package's:
the rules table and ``make_rules`` for all ten archs; every parameter,
cache (``decode_32k``, ``long_500k``), optimizer-state (AdamW and
Adafactor) and batch leaf of all ten archs on both production meshes
(16x16 and 2x16x16), its spec and its per-card shard shape equal to the
reference's ``sharding_for_spec`` on a ``jax.sharding.AbstractMesh`` of
the same shape; the divisibility and one-axis-per-spec guards; and
``logical_constraint`` outside an environment and, in a subprocess on a
fake (2, 4) mesh, on a DTensor.

The reference stacks a scan group's layers along a leading axis (spec
``None`` there); the port keeps one leaf a layer, so that entry is dropped
before the comparison (``convert.reference_layout`` pairs the leaves).
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jax
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
import repro.distributed.sharding as jsh
import repro.models.model as jmodel
import repro.train.optimizer as jopt
from repro_torch.configs import SHAPES, get_config, list_archs, shape_cells
from repro_torch.convert import layer_groups, reference_layout
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun as tdry
from repro_torch.models import cache_axes, cache_specs, param_axes, param_specs
from repro_torch.train import OptConfig

ARCHS = list_archs()
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jdry():
    """``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host devices when
    imported: initialise the backend first and restore the variable, so
    that nothing else in this process sees it."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return module


def _meshes(name):
    names, sizes = MESHES[name]
    return AbstractMesh(sizes, names), tsh.MeshShape(names, sizes)


def _is_leaf(x):
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], tuple) \
        and isinstance(x[1], str)


def _flat(tree, leaf=_is_leaf) -> dict:
    """{"/"-joined path: leaf} of the reference's nested dicts and lists."""
    out = {}

    def walk(node, prefix):
        if leaf(node):
            out[prefix[:-1]] = node
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                walk(x, f"{prefix}{i}/")
        else:
            out[prefix[:-1]] = node

    walk(tree, "")
    return out


def _same(ref_sh, ref_shape, port_sh, port_shape, stacked=False):
    """The reference's spec and shard shape against the port's, the
    stacked axis (spec None) dropped."""
    spec, shard = tuple(ref_sh.spec), tuple(ref_sh.shard_shape(ref_shape))
    spec = spec + (None,) * (len(ref_shape) - len(spec))
    if stacked:
        assert spec[0] is None
        spec, shard, ref_shape = spec[1:], shard[1:], tuple(ref_shape[1:])
    got = tuple(port_sh.spec) + (None,) * (len(port_shape) - len(port_sh.spec))
    assert tuple(port_shape) == tuple(ref_shape)
    assert got == spec, (got, spec)
    assert port_sh.shard_shape(port_shape) == shard, (port_sh.shard_shape(port_shape), shard)


def _rules(arch, shape=None):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    over = {"kv_seq": "model"} if shape == "long_500k" else {}
    return cfg, jcfg, tsh.make_rules(cfg, **over), jsh.make_rules(jcfg, **over)


def test_default_rules_equal_reference():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert len(tsh.DEFAULT_RULES) == 12
    import repro_torch.distributed as tdist

    assert tdist.DEFAULT_RULES is tsh.DEFAULT_RULES
    assert tsh.make_rules() == jsh.make_rules() and tsh.make_rules() is not tsh.DEFAULT_RULES


@pytest.mark.parametrize("arch", ARCHS)
def test_make_rules_equal_reference(arch):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    assert tsh.make_rules(cfg) == jsh.make_rules(jcfg)
    assert tsh.make_rules(cfg, kv_seq="model") == jsh.make_rules(jcfg, kv_seq="model")
    assert tsh.make_rules(cfg, batch="data", vocab=None) == \
        jsh.make_rules(jcfg, batch="data", vocab=None)
    if arch == "whisper-base":      # attn_tp=False: heads replicate
        assert not cfg.attn_tp
        rules = tsh.make_rules(cfg)
        assert rules["heads"] is None and rules["kv_heads"] is None
    if cfg.seq_shard:
        assert tsh.make_rules(cfg)["seq"] == "model"


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_leaves_equal_reference(arch, mesh):
    cfg, jcfg, rules, jrules = _rules(arch)
    jmesh, tmesh = _meshes(mesh)
    ref = _flat(jmodel.param_specs(jcfg))
    specs, axes = param_specs(cfg), param_axes(cfg)
    layout = reference_layout(cfg)
    assert sorted(layout) == sorted(ref)
    n = 0
    for path, (names, stacked) in layout.items():
        shape, dt, ref_axes = ref[path]
        rsh = jsh.sharding_for_spec(shape, ref_axes, jmesh, jrules, jcfg.fsdp)
        for name in names:
            assert axes[name] == (ref_axes[1:] if stacked else ref_axes)
            assert specs[name][1] == dt
            _same(rsh, shape, tsh.sharding_for_spec(specs[name][0], axes[name], tmesh,
                                                     rules, cfg.fsdp),
                  specs[name][0], stacked)
            n += 1
    assert n == len(specs)


def _reference_cache_by_layer(jcfg, cfg, B, S) -> list:
    """The reference's cache leaves of layer i (``index`` left out) and
    whether they are stacked, in layer order."""
    blocks = jmodel.cache_specs(jcfg, B, S)["blocks"]
    out = [None] * cfg.num_layers
    for g, block in zip(layer_groups(cfg), blocks):
        if not g["scan"]:
            for i, leaves in zip(g["indices"], block["layers"]):
                out[i] = (leaves, False)
        else:
            for pos, leaves in enumerate(block["pattern"]):
                for r in range(g["repeat"]):
                    out[g["start"] + r * g["period"] + pos] = (leaves, True)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_leaves_equal_reference(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    shapes = [s for s in ("decode_32k", "long_500k") if s in shape_cells(arch)]
    for shape_name in shapes:
        cfg, jcfg, rules, jrules = _rules(arch, shape_name)
        shape = SHAPES[shape_name]
        B, S = shape.global_batch, shape.seq_len
        specs, axes = cache_specs(cfg, B, S), cache_axes(cfg, B, S)
        ref = _reference_cache_by_layer(jcfg, cfg, B, S)
        for i, (leaves, stacked) in enumerate(ref):
            assert sorted(specs["layers"][i]) == sorted(k for k in leaves if k != "index")
            for name, (pshape, dt) in specs["layers"][i].items():
                rshape, rdt, raxes = leaves[name]
                assert rdt == dt and axes["layers"][i][name] == (raxes[1:] if stacked
                                                                 else raxes)
                _same(jsh.sharding_for_spec(rshape, raxes, jmesh, jrules), rshape,
                      tsh.sharding_for_spec(pshape, axes["layers"][i][name], tmesh, rules),
                      pshape, stacked)
        jtree = jmodel.cache_specs(jcfg, B, S)
        assert jtree["pos"] == specs["pos"] + (axes["pos"],)
        if cfg.encoder_layers:
            for (pk, pv), (ak, av), (rk, rv) in zip(specs["enc_kv"], axes["enc_kv"],
                                                   jtree["enc_kv"]):
                for p, a, r in ((pk, ak, rk), (pv, av, rv)):
                    _same(jsh.sharding_for_spec(r[0], r[2], jmesh, jrules), r[0],
                          tsh.sharding_for_spec(p[0], a, tmesh, rules), p[0])
        else:
            assert specs["enc_kv"] is None and jtree["enc_kv"] is None


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_state_equal_reference(jdry, arch, mesh):
    """AdamW's m and v and Adafactor's factored vr and vc, as the
    reference's ``opt_shardings`` lays them out (both optimizers, whatever
    the arch's own)."""
    cfg, jcfg, rules, jrules = _rules(arch)
    jmesh, tmesh = _meshes(mesh)
    jspecs = jmodel.param_specs(jcfg)
    j_psh = jsh.tree_shardings(jspecs, jmesh, jrules, fsdp=jcfg.fsdp)
    p_specs = tdry.reference_specs(cfg)
    assert p_specs == _flat(jspecs)
    t_psh = tsh.tree_shardings(p_specs, tmesh, rules, cfg.fsdp)
    for kind in ("adamw", "adafactor"):
        o_structs = jax.eval_shape(
            lambda p, kind=kind: jopt.init_opt_state(p, jopt.OptConfig(kind=kind)),
            jsh.spec_struct(jspecs))
        j_osh = jdry.opt_shardings(o_structs, j_psh, jmesh, p_specs=jspecs,
                                   rules=jrules, fsdp=jcfg.fsdp)
        o_specs = tdry.opt_specs(p_specs, OptConfig(kind=kind))
        t_osh = tdry.opt_shardings(o_specs, t_psh, tmesh, p_specs, rules, cfg.fsdp)
        assert sorted(t_osh) == sorted(j_osh) == sorted(o_specs)
        assert tuple(t_osh["step"].spec) == tuple(j_osh["step"].spec) == ()
        for key in o_specs:
            if key == "step":
                continue
            shapes = {p: tuple(s.shape) for p, s in _flat(
                o_structs[key], leaf=lambda x: hasattr(x, "shape")).items()}
            shs = _flat(j_osh[key], leaf=lambda x: hasattr(x, "spec"))
            assert sorted(shapes) == sorted(o_specs[key])
            for path, (shape, dt, _) in o_specs[key].items():
                assert dt == "float32"
                _same(shs[path], shapes[path], t_osh[key][path], shape)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_sharding_equal_reference(jdry, mesh):
    jmesh, tmesh = _meshes(mesh)
    for shape in SHAPES.values():
        B, S = shape.global_batch, shape.seq_len
        for over in ({}, {"batch": "data"}, {"batch": ("pod",)}):
            rules, jrules = tsh.make_rules(**over), jsh.make_rules(**over)
            _same(jdry._batch_sharding(jmesh, B, jrules), (B, S),
                  tdry._batch_sharding(tmesh, B, rules), (B, S))
    for arch in ("whisper-base", "phi-3-vision-4.2b", "qwen2.5-3b"):
        cfg, jcfg, rules, jrules = _rules(arch)
        shape = SHAPES["train_4k"]
        st, sh = tdry.batch_specs(cfg, shape, tmesh, rules)
        jst, jsh_ = jdry.batch_specs(jcfg, shape, jmesh, jrules)
        assert sorted(st) == sorted(jst)
        for k, (s, dt) in st.items():
            assert str(jst[k].dtype) == dt
            _same(jsh_[k], tuple(jst[k].shape), sh[k], s)


def test_guards_equal_reference():
    """The reference's case 3: experts and expert_ffn both ask for the
    model axis, the first dim wins; and a dim the axes do not divide
    replicates."""
    jmesh, tmesh = AbstractMesh((2, 4), ("data", "model")), \
        tsh.MeshShape(("data", "model"), (2, 4))
    rules, jrules = tsh.make_rules(), jsh.make_rules()
    cases = [((4, 8, 16), ("experts", None, "expert_ffn")),
             ((6, 8, 16), ("experts", None, "expert_ffn")),
             ((7, 8), ("vocab", None)),
             ((8, 16), ("batch", "vocab")),
             ((2, 512, 8), (None, None, "heads")),
             ((6, 1024), ("batch", None)),
             ((256, 1024), (None, None)),        # FSDP skips a dim below 512
             ((16, 512), (None, "vocab"))]
    for shape, axes in cases:
        for fsdp in (False, True):
            _same(jsh.sharding_for_spec(shape, axes, jmesh, jrules, fsdp), shape,
                  tsh.sharding_for_spec(shape, axes, tmesh, rules, fsdp), shape)
    sh = tsh.sharding_for_spec((4, 8, 16), ("experts", None, "expert_ffn"), tmesh, rules)
    assert sh.spec == ("model", None, None)
    assert tsh.sharding_for_spec((7, 8), ("vocab", None), tmesh, rules).spec == (None, None)
    assert tsh.sharding_for_spec((2, 512, 8), (None, None, "heads"), tmesh, rules,
                                 fsdp=True).spec == (None, "data", "model")
    assert tsh.sharding_for_spec((256, 1024), (None, None), tmesh, rules,
                                 fsdp=True).spec == (None, "data")


def test_logical_constraint_outside_an_environment():
    x = torch.zeros(4, 8)
    assert tsh.logical_constraint(x, "batch", None) is x
    assert tsh.current_env() is None
    mesh = tsh.MeshShape(("data", "model"), (2, 4))
    with tsh.axis_env(mesh, tsh.make_rules()):
        assert tsh.current_env()[0] is mesh
        assert tsh.logical_constraint(x, "batch", None) is x   # not a DTensor
        with pytest.raises(ValueError, match="2 names for rank-3"):
            tsh.logical_constraint(torch.zeros(2, 3, 4), "batch", None)
    assert tsh.current_env() is None


_SUBPROC = r"""
import sys
sys.path.insert(0, "src")
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.distributed.sharding import (axis_env, logical_constraint,
                                              make_rules, sharding_for_spec)
from repro_torch.launch.mesh import make_host_mesh

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_host_mesh(2, 4)
assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (2, 4)
assert tuple(make_host_mesh(4, 4).shape) == (8, 1)      # the shrink rule
x = distribute_tensor(torch.zeros(8, 16, 6), mesh, [Replicate(), Replicate()])
rules = make_rules()
with axis_env(mesh, rules):
    y = logical_constraint(x, "batch", "vocab", None)
    z = logical_constraint(x, "batch", None, "heads")     # 6 % 4: replicated
assert tuple(y.placements) == (Shard(0), Shard(1)), y.placements
assert tuple(y.to_local().shape) == (4, 4, 6)
assert tuple(z.placements) == (Shard(0), Replicate()), z.placements
sh = sharding_for_spec((8, 16, 6), ("batch", "vocab", None), mesh, rules)
assert sh.placements == (Shard(0), Shard(1)) and sh.shard_shape((8, 16, 6)) == (4, 4, 6)
assert logical_constraint(x, "batch", None, None) is x   # outside: a no-op
print("SUBPROCESS_OK")
"""


def test_logical_constraint_on_a_fake_mesh():
    r = subprocess.run([sys.executable, "-c", _SUBPROC], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert "SUBPROCESS_OK" in r.stdout, r.stdout + "\n" + r.stderr[-3000:]


_HOST_MESH = r"""
import sys
sys.path.insert(0, "src")
import torch.distributed as dist
from repro_torch.launch.mesh import make_host_mesh

mesh = make_host_mesh(2, 2)    # no group yet: one of this process, (2, 2) shrinks
assert dist.get_world_size() == 1 and tuple(mesh.shape) == (1, 1), mesh
assert dist.get_backend() == "gloo"
dist.destroy_process_group()
print("SUBPROCESS_OK")
"""


def test_host_mesh_without_a_group():
    r = subprocess.run([sys.executable, "-c", _HOST_MESH], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert "SUBPROCESS_OK" in r.stdout, r.stdout + "\n" + r.stderr[-3000:]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "jamba-v0.1-52b", "whisper-base"])
def test_opt_specs_are_the_optimizers_state(arch):
    """``opt_specs``' shapes are what ``train.optimizer.init_opt_state``
    allocates (built on fake tensors: nothing is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import LM
    from repro_torch.train import init_opt_state

    cfg = get_config(arch)
    structs = tsh.spec_struct(tdry.reference_specs(cfg))
    assert {p: (tuple(t.shape), t.dtype, t.device.type) for p, t in structs.items()} == \
        {p: (s, torch.bfloat16 if d == "bfloat16" else torch.float32, "meta")
         for p, (s, d, _) in tdry.reference_specs(cfg).items()}
    with FakeTensorMode():
        model = LM(cfg, "cpu")
        for kind in ("adamw", "adafactor"):
            state = init_opt_state(model, OptConfig(kind=kind))
            specs = tdry.opt_specs(tdry.reference_specs(cfg), OptConfig(kind=kind))
            assert sorted(state) == sorted(specs)
            for key in specs:
                if key == "step":
                    assert tuple(state[key].shape) == specs[key][0] == ()
                    continue
                assert {p: tuple(t.shape) for p, t in state[key].items()} == \
                    {p: s for p, (s, _, _) in specs[key].items()}
