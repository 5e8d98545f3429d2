"""PyTorch port, the Mamba-2 configs trained on a mesh of ranks (gloo on
the CPU): reduced mamba2-2.7b (no ``seq_shard``: the sequence stays
whole, the Mamba-2 leaves' ``ffn`` columns shard over ``model``) and
reduced jamba-v0.1-52b (one 8-layer period: attention, MoE and Mamba-2
layers; ``seq_shard``, so the sequence shards over ``model``; ``fsdp``
kept on and an expert width of 512, so that ZeRO-3 shards its experts
over ``data``) on meshes 2x2, 4x1 and 1x4, against the port's one
process and the reference's jitted step on the same parameters and
batch.  Bars, float32: loss 1e-5, each gradient leaf 1e-4 of its
largest entry, parameters after two AdamW steps 2e-3 (those of
``test_torch_mesh_train.py``).

One ``torch.distributed.run`` job of four ranks runs this file as a
script (``_worker``); besides the two configs it runs one ``Mamba2``
block at d_model 512 with ZeRO-3 on (its leaves sharded over both axes)
on 2 x 2, the sequence sharded and whole.  The launcher trains both
configs on a mesh under ``torch.distributed.run``.  The worker's DTensor
refuses, as PyTorch 2.11's does, a view that flattens a
sharded dimension other than the first (``strict_views``).  Each
subprocess has its own timeout.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import flatten_paths, lm_grads_to_arrays, \
    lm_params_from_arrays, lm_params_to_arrays  # noqa: E402
from repro_torch.train import global_norm, grads_of, init_opt_state, \
    make_train_step  # noqa: E402
from test_torch_mesh_train import GRAD_TOL, LOSS_TOL, OPT, PARAM_TOL, RUN_TIMEOUT, \
    TCFG, _assert_leaves, _batch, _item, _jax_np, _load, _one_process, _save, \
    _torchrun, strict_views  # noqa: E402

ARCHS = ["mamba2-2.7b", "jamba-v0.1-52b"]
MESHES = [(2, 2), (4, 1), (1, 4)]
JOB_TIMEOUT = 400
OVER = {"jamba-v0.1-52b": {"fsdp": True, "moe_d_ff": 512}}
BLOCK = dict(d_model=512, fsdp=True)     # one Mamba-2 block with ZeRO-3 leaves


def _cfg(arch, registry=get_config):
    return dataclasses.replace(registry(arch).reduced(), **OVER.get(arch, {}))


# ---------------------------------------------------------------------------
# the worker: one process a rank
# ---------------------------------------------------------------------------

def _train_on_meshes(out: Path, rank: int):
    import torch.distributed as dist

    from repro_torch.convert import reference_layout
    from repro_torch.distributed.sharding import MeshSharding, axis_env, \
        distribute_model, make_rules, moment_sharding, param_shardings, spec_of
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params

    for arch in ARCHS:
        inp = _load(out / f"in_{arch}.npz")
        cfg = _cfg(arch)
        layout = reference_layout(cfg)
        for dp, mp in MESHES:
            mesh = make_host_mesh(dp, mp, device="cpu")
            rules = make_rules(cfg)
            res = {}
            sh = param_shardings(cfg, mesh, rules)
            meshed = init_params(cfg, torch.Generator().manual_seed(7), "cpu",
                                 mesh=mesh, rules=rules)
            whole = dict(init_params(cfg, torch.Generator().manual_seed(7),
                                     "cpu").named_parameters())
            res["init_ok"] = np.array(all(torch.equal(p.full_tensor(), whole[n])
                                          for n, p in meshed.named_parameters()))
            res["placed_ok"] = np.array(all(
                tuple(p.placements) == tuple(sh[n].placements)
                and tuple(p.to_local().shape) == sh[n].shard_shape(p.shape)
                for n, p in meshed.named_parameters()))
            del meshed, whole
            model = distribute_model(lm_params_from_arrays(
                cfg, inp["arrays"], device="cpu"), mesh, rules).requires_grad_(True)
            with axis_env(mesh, rules):
                grads, loss, m = grads_of(model, inp["batch"], cfg, TCFG)
                res["loss"] = np.array(_item(loss))
                res["metrics"] = {k: np.array(_item(v)) for k, v in m.items()}
                res["grads"] = lm_grads_to_arrays(model, grads)
                res["gnorm"] = np.array(global_norm(grads).item())
                res["placed_grads"] = np.array(all(
                    tuple(grads[n].placements) == tuple(p.placements)
                    for n, p in model.named_parameters()))
                del grads
                step = make_train_step(cfg, OPT, TCFG)
                opt = init_opt_state(model, OPT)
                params = dict(model.named_parameters())
                res["moments_placed"] = np.array(all(
                    tuple(opt[k][path].placements) == tuple(moment_sharding(
                        MeshSharding(mesh, spec_of(params[names[0]])),
                        stacked).placements)
                    for k in ("m", "v") for path, (names, stacked) in layout.items()))
                gns = []
                for _ in range(2):
                    model, opt, om = step(model, opt, inp["batch"])
                    gns.append(float(om["grad_norm"]))
                res["step_gnorms"] = np.array(gns)
                res["stepped"] = lm_params_to_arrays(model)
            if rank == 0:
                _save(out / f"out_{arch}_{dp}x{mp}.npz", res)
            del model, opt
            dist.barrier()


def _block_leaves(cfg, seed=5):
    from repro_torch.models.layers import Mamba2

    block = Mamba2(cfg, "cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in block.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (0.02 if p.ndim > 1 else 0.5))
        block.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, block.H)))
    return block


def _block_on_mesh(out: Path, rank: int):
    """One Mamba-2 block, its leaves placed as the rules (ZeRO-3 on) say,
    on 2 x 2 with the sequence sharded over ``model`` and whole: the
    output and every gradient against one process."""
    from repro_torch.distributed.sharding import axis_env, distribute, env_placements, \
        make_rules, sharding_for_spec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import mamba2_specs

    cfg = dataclasses.replace(get_config("mamba2-2.7b").reduced(), **BLOCK)
    block = _block_leaves(cfg).requires_grad_(True)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(4, 24, cfg.d_model, generator=g)
    w = torch.randn(4, 24, cfg.d_model, generator=g)
    xin = x.clone().requires_grad_(True)
    names = [n for n, _ in block.named_parameters()]
    want = block(xin)
    want_g = torch.autograd.grad((want * w).sum(), [xin, *block.parameters()])
    specs = mamba2_specs(cfg)
    specs.update({f"out_norm.{k}": v for k, v in specs.pop("out_norm").items()})
    mesh = make_host_mesh(2, 2, device="cpu")
    res = {}
    for seq in ("model", None):
        rules = make_rules(cfg, seq=seq)
        meshed = _block_leaves(cfg)
        sharded = []
        with torch.no_grad():
            for n in names:
                owner = meshed.out_norm if n.startswith("out_norm.") else meshed
                leaf = n.split(".")[-1]
                shape, _, axes = specs[n]
                sh = sharding_for_spec(shape, axes, mesh, rules, fsdp=cfg.fsdp)
                sharded.append(any(p.is_shard() for p in sh.placements))
                setattr(owner, leaf, torch.nn.Parameter(distribute(
                    getattr(owner, leaf).detach(), mesh, sh.placements)))
        with axis_env(mesh, rules):
            xp = env_placements(("batch", "seq", None), x.shape)
            xd = distribute(x, mesh, xp).requires_grad_(True)
            got = meshed(xd)
            got_g = torch.autograd.grad((got * distribute(w, mesh, got.placements)).sum(),
                                        [xd, *meshed.parameters()])
        errs = [((a.full_tensor() - b).abs().max() / b.abs().max()).item()
                for a, b in zip((got, *got_g), (want, *want_g))]
        res[str(seq)] = dict(errs=errs, placed=tuple(got.placements) == tuple(xp),
                             zero3=sum(sharded))
    if rank == 0:
        (out / "block.json").write_text(json.dumps(res))


def _worker(directory: str):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    strict_views()
    make_host_mesh(1, 1, device="cpu")          # initialises the group
    rank = dist.get_rank()
    _train_on_meshes(Path(directory), rank)
    _block_on_mesh(Path(directory), rank)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the references and the tests
# ---------------------------------------------------------------------------

def _reference(arch):
    """The JAX package's float32 parameters (its seeded init), the batch,
    its loss and metrics, gradients, and the parameters after two AdamW
    steps."""
    import jax

    import repro.models as jmodels
    import repro.train as jtrain
    from repro.configs import get_config as jax_get_config

    cfg = _cfg(arch, jax_get_config)
    params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain.loss_fn(p, b, cfg, TCFG), has_aux=True))
    apply = jax.jit(lambda p, g, o: jtrain.apply_updates(p, g, o, OPT))
    (loss, m), grads = vg(params, batch)
    out = dict(arrays=_jax_np(params), batch=batch, grads=_jax_np(grads),
               metrics={"loss": float(loss), **{k: float(v) for k, v in m.items()}})
    p, o = params, jtrain.init_opt_state(params, OPT)
    for _ in range(2):
        _, g = vg(p, batch)
        p, o, _ = apply(p, g, o)
    out["stepped"] = _jax_np(p)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both configs on every mesh and the block in one job of four ranks;
    the references."""
    d = tmp_path_factory.mktemp("mesh_ssm")
    refs, ports = {}, {}
    for arch in ARCHS:
        refs[arch] = _reference(arch)
        _save(d / f"in_{arch}.npz", {"arrays": refs[arch]["arrays"],
                                     "batch": refs[arch]["batch"]})
        ports[arch] = _one_process(_cfg(arch), refs[arch]["arrays"], refs[arch]["batch"])
    rc, _, err = _torchrun(4, [str(Path(__file__)), "worker", str(d)], JOB_TIMEOUT,
                           d / "logs")
    assert rc == 0, err[-6000:]
    got = {f"{arch}_{dp}x{mp}": _load(d / f"out_{arch}_{dp}x{mp}.npz")
           for arch in ARCHS for dp, mp in MESHES}
    got["block"] = json.loads((d / "block.json").read_text())
    return refs, ports, got


CASES = [(arch, f"{dp}x{mp}") for arch in ARCHS for dp, mp in MESHES]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_init_and_state_placed_as_the_rules(runs, arch, mesh):
    """The init is the one-process draw bit for bit, each leaf placed as
    ``tree_shardings`` says with ``shard_shape`` blocks; the gradients and
    the AdamW moments take the same placements."""
    r = runs[2][f"{arch}_{mesh}"]
    assert bool(r["init_ok"]) and bool(r["placed_ok"])
    assert bool(r["placed_grads"]) and bool(r["moments_placed"])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_loss_and_grads_match_one_process_and_reference(runs, arch, mesh):
    refs, ports, got = runs
    r = got[f"{arch}_{mesh}"]
    for want in (refs[arch], ports[arch]):
        assert abs(float(r["loss"]) - want["metrics"]["loss"]) < LOSS_TOL
        for k in ("nll", "aux", "z"):
            assert abs(float(r["metrics"][k]) - want["metrics"][k]) < LOSS_TOL, k
        _assert_leaves(r["grads"], want["grads"], GRAD_TOL, arch)
    np.testing.assert_allclose(float(r["gnorm"]), ports[arch]["gnorm"], rtol=1e-5)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_adamw_steps_match_one_process_and_reference(runs, arch, mesh):
    refs, ports, got = runs
    r = got[f"{arch}_{mesh}"]
    for want in (refs[arch]["stepped"], ports[arch]["stepped"]):
        g, w = flatten_paths(r["stepped"]), flatten_paths(want)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=PARAM_TOL, err_msg=k)
    np.testing.assert_allclose(r["step_gnorms"], ports[arch]["step_gnorms"], rtol=1e-5)


@pytest.mark.parametrize("seq", ["model", "None"])
def test_mamba_block_with_zero3_leaves(runs, seq):
    """One Mamba-2 block (d_model 512, ZeRO-3 on: its leaves sharded over
    ``data`` and ``model``) on 2 x 2, the sequence sharded over ``model``
    or whole: the output and each gradient (of the input and of every
    leaf) within 1e-5 of one process's largest entry, the output placed
    as its input (the residual stream's placements)."""
    r = runs[2]["block"][seq]
    assert r["placed"] and r["zero3"] >= 4, r
    assert max(r["errs"]) <= 1e-5, r["errs"]


TINY = ["--reduced", "--batch", "8", "--seq", "16", "--steps", "3", "--log-every", "1",
        "--device", "cpu", "--lr", "1e-3"]


@pytest.mark.parametrize("arch,mesh", [("mamba2-2.7b", (1, 4)), ("jamba-v0.1-52b", (2, 2))])
def test_launcher_trains_on_a_mesh(tmp_path, arch, mesh):
    """The launcher trains the config under ``torch.distributed.run`` on
    the mesh: its losses are one process's to 1e-5."""
    from repro_torch.launch import train as launch_train

    whole = launch_train.main(["--arch", arch, *TINY])
    d, m = mesh
    rc, _, err = _torchrun(d * m, ["-m", "repro_torch.launch.train", "--arch", arch, *TINY,
                                   "--data-parallel", str(d), "--model-parallel", str(m),
                                   "--metrics-out", str(tmp_path / "m.json")],
                           RUN_TIMEOUT, tmp_path / "logs")
    assert rc == 0, err[-6000:]
    got = json.loads((tmp_path / "m.json").read_text())
    assert [h["step"] for h in got] == [0, 1, 2]
    np.testing.assert_allclose([h["loss"] for h in got], [h["loss"] for h in whole],
                               rtol=0, atol=LOSS_TOL)


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(sys.argv[2])
