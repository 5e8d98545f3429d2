"""PyTorch port, the dense and MoE configs trained on a mesh of ranks
(gloo on the CPU), with the full configs' features switched back on:
reduced stablelm-1.6b and stablelm-3b (partial rotary, LayerNorm, the
sequence sharded over ``model``), nemotron-4-340b (ZeRO-3, the
``"dots"`` remat, the ``relu2`` MLP) and mixtral-8x7b (ZeRO-3 experts
in 16 dispatch groups, a sliding window of 8 over a sequence of 32, so
that on 1 x 4 the band crosses the ranks' blocks of the sequence), each
with ``remat`` on under its own policy, on meshes 2x2, 4x1 and 1x4,
against the port's one process and the reference's jitted step on the
same parameters and batch.  nemotron and mixtral take a width of 512
(``WIDE``), the least at which ZeRO-3 shards a leaf: every leaf is
placed as the full config's is on the same mesh (no leaf quietly
replicated by the divisibility guard).  Bars, float32: loss 1e-5, each
gradient leaf 1e-4 of its largest entry, parameters after two AdamW
steps 2e-3 (those of ``test_torch_mesh_train.py``).

One ``torch.distributed.run`` job of four ranks runs this file as a
script (``_worker``): every config on every mesh, and mixtral's step on
2 x 2 with its collectives counted by kind (``CommDebugMode``) against
the dry run's ``count_collectives``.  The launcher trains each config on
a mesh under ``torch.distributed.run``.  The worker's DTensor refuses,
as PyTorch 2.11's does, a view that flattens a sharded dimension other
than the first (``strict_views``).  Each subprocess has its own timeout.
The helpers here serve ``test_torch_mesh_frontends.py`` too.
"""
import collections
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

from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.convert import flatten_paths, lm_grads_to_arrays, \
    lm_params_from_arrays, lm_params_to_arrays  # noqa: E402
from repro_torch.distributed.sharding import MeshShape, make_rules, \
    param_shardings  # noqa: E402
from repro_torch.train import global_norm, grads_of, init_opt_state, \
    make_train_step  # noqa: E402
from test_torch_mesh_train import GRAD_TOL, LOSS_TOL, OPT, PARAM_TOL, RUN_TIMEOUT, \
    TCFG, _assert_leaves, _item, _jax_np, _load, _save, _torchrun, \
    strict_views  # noqa: E402

ARCHS = ["stablelm-1.6b", "stablelm-3b", "nemotron-4-340b", "mixtral-8x7b"]
MESHES = [(2, 2), (4, 1), (1, 4)]
B, S = 8, 32
JOB_TIMEOUT = 400
# the least width at which ZeRO-3 shards a leaf (sharding_for_spec), with
# grouped kv heads as the full configs have them
WIDE = dict(d_model=512, num_heads=8, num_kv_heads=2, head_dim=64)
# kv heads shard over "model" only in a multiple of 16 (attention_specs), as
# stablelm's 32 do
KV16 = dict(num_heads=16, num_kv_heads=16)
OVER = {"stablelm-1.6b": KV16, "stablelm-3b": KV16,
        "nemotron-4-340b": dict(WIDE, d_ff=1024),
        "mixtral-8x7b": dict(WIDE, moe_d_ff=512, window=8)}
# mixtral's batch: each token's second and third experts apart by more than
# float32 noise in both steps (test_routing_has_no_near_tie)
SEEDS = {"mixtral-8x7b": 6}
ROUTE_GAP = 1e-5
COUNTED = ("mixtral-8x7b", (2, 2))       # the step whose collectives are counted
KINDS = {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
         "all_reduce": "all-reduce", "all_to_all_single": "all-to-all",
         "shard_dim_alltoall": "all-to-all"}


def full_features(arch, over, registry=get_config):
    """The reduced config with the full one's ``fsdp``, ``remat`` and
    ``remat_policy`` back on, and ``over`` on top."""
    full = registry(arch)
    return dataclasses.replace(full.reduced(), fsdp=full.fsdp, remat=full.remat,
                               remat_policy=full.remat_policy, **over)


def _cfg(arch, registry=get_config):
    return full_features(arch, OVER[arch], registry)


def mesh_batch(cfg, seq=S, seed=1):
    """A batch of ``B`` rows of ``seq`` tokens, with the frontend stub's
    extras (``frames`` or ``patch_embeds``, float32) where the config has
    one."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    elif cfg.frontend == "vision_stub":
        batch["patch_embeds"] = rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)
                                           ).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# the worker: one process a rank
# ---------------------------------------------------------------------------

def train_on_meshes(out: Path, rank: int, archs, cfg_of, meshes=MESHES):
    """Each config on each mesh from ``out/in_<arch>.npz``: the meshed init
    against one process's, every leaf's, gradient's and moment's
    placement, the loss, metrics and gradients, and the parameters after
    two AdamW steps, into ``out/out_<arch>_<d>x<m>.npz`` (rank 0)."""
    import torch.distributed as dist

    from repro_torch.convert import reference_layout
    from repro_torch.distributed.sharding import MeshSharding, axis_env, \
        distribute_model, moment_sharding, spec_of
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params

    for arch in archs:
        inp = _load(out / f"in_{arch}.npz")
        cfg = cfg_of(arch)
        layout = reference_layout(cfg)
        for dp, mp in meshes:
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


def count_kinds(out: Path, rank: int, arch: str, cfg, mesh_shape, batch):
    """The collectives of ``cfg``'s meshed gradients on ``mesh_shape`` by
    kind, into ``out/collectives_<arch>.json``, and each all-gather's
    result (shape and bytes) into ``out/gathers_<arch>.json`` (rank 0).
    Gloo has no all-to-all: DTensor runs each as an all-gather and a
    chunk (``shard_dim_alltoall``) on the CPU, so those calls count as
    the all-to-alls they are on the card, and their gathers are not
    listed."""
    import torch.distributed.tensor.placement_types as pt
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed.sharding import axis_env
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params

    calls = []
    plain = pt.shard_dim_alltoall
    mesh = make_host_mesh(*mesh_shape, device="cpu")
    rules = make_rules(cfg)
    model = init_params(cfg, torch.Generator().manual_seed(7), "cpu", mesh=mesh,
                        rules=rules).requires_grad_(True)
    gathers, inside = [], []

    class Sized(CommDebugMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = super().__torch_dispatch__(func, types, args, kwargs)
            if (res is not NotImplemented and not inside
                    and not isinstance(func, torch._ops.HigherOrderOperator)
                    and str(func._overloadpacket).endswith("all_gather_into_tensor")):
                gathers.append([list(res.shape), res.numel() * res.element_size()])
            return res

    def alltoall(*a, **k):
        calls.append(1)
        inside.append(1)
        try:
            return plain(*a, **k)
        finally:
            inside.pop()

    pt.shard_dim_alltoall = alltoall
    try:
        mode = Sized()
        with axis_env(mesh, rules), mode:
            grads_of(model, batch, cfg, TCFG)
    finally:
        pt.shard_dim_alltoall = plain
    kinds = collections.Counter()
    for op, n in mode.get_comm_counts().items():
        kinds[KINDS[str(op).split(".")[-1]]] += n
    kinds["all-gather"] -= len(calls)
    kinds["all-to-all"] += len(calls)
    if rank == 0:
        (out / f"collectives_{arch}.json").write_text(
            json.dumps({k: n for k, n in kinds.items() if n}))
        (out / f"gathers_{arch}.json").write_text(json.dumps(gathers))


def _worker(directory: str):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    strict_views()
    make_host_mesh(1, 1, device="cpu")          # initialises the group
    rank = dist.get_rank()
    out = Path(directory)
    train_on_meshes(out, rank, ARCHS, _cfg)
    arch, mesh = COUNTED
    count_kinds(out, rank, arch, _cfg(arch), mesh, _load(out / f"in_{arch}.npz")["batch"])
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the references and the tests
# ---------------------------------------------------------------------------

def reference_run(cfg, arrays, batch):
    """The JAX package's loss and metrics, gradients, and the parameters
    after two AdamW steps for ``cfg`` (the JAX package's config) from the
    parameters ``arrays`` on ``batch``."""
    import jax
    import jax.numpy as jnp

    import repro.train as jtrain

    params = jax.tree.map(jnp.asarray, arrays)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain.loss_fn(p, b, cfg, TCFG), has_aux=True))
    apply = jax.jit(lambda p, g, o: jtrain.apply_updates(p, g, o, OPT))
    (loss, m), grads = vg(params, batch)
    out = dict(grads=_jax_np(grads),
               metrics={"loss": float(loss), **{k: float(v) for k, v in m.items()}})
    p, o = params, jtrain.init_opt_state(params, OPT)
    for _ in range(2):
        _, g = vg(p, batch)
        p, o, _ = apply(p, g, o)
    out["stepped"] = _jax_np(p)
    return out


def one_process(cfg, arrays, batch):
    """The port's one-process loss, metrics, gradients and norm, the
    parameters after two AdamW steps, and the least gap between a token's
    second and third router probabilities over the steps' MoE layers
    (inf without experts)."""
    import repro_torch.models.layers as tl

    model = lm_params_from_arrays(cfg, arrays, device="cpu").requires_grad_(True)
    gaps = [np.inf]
    plain = tl.moe_one_group

    def routed(xg, router, *a, **k):
        top = torch.softmax(xg.float() @ router, -1).topk(3, -1).values
        gaps.append((top[..., 1] - top[..., 2]).min().item())
        return plain(xg, router, *a, **k)

    tl.moe_one_group = routed
    try:
        grads, loss, m = grads_of(model, batch, cfg, TCFG)
        out = {"metrics": {"loss": loss.item(), **{k: v.item() for k, v in m.items()}},
               "grads": lm_grads_to_arrays(model, grads),
               "gnorm": global_norm(grads).item()}
        step, state, gns = make_train_step(cfg, OPT, TCFG), init_opt_state(model, OPT), []
        for _ in range(2):
            model, state, om = step(model, state, batch)
            gns.append(om["grad_norm"].item())
    finally:
        tl.moe_one_group = plain
    out.update(stepped=lm_params_to_arrays(model), step_gnorms=gns, route_gap=min(gaps))
    return out


def start_torchrun(nproc: int, args: list, log_dir: Path):
    """``python -m torch.distributed.run --standalone`` started in the
    background, each rank's output kept under ``log_dir``."""
    import subprocess

    from test_torch_mesh_train import _env

    log_dir.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "--redirects", "3", "--log-dir",
           str(log_dir / "ranks"), *args]
    with open(log_dir / "launcher.err", "w") as err:
        return subprocess.Popen(cmd, cwd=ROOT, env=_env(), stdout=subprocess.DEVNULL,
                                stderr=err)


def finish_torchrun(proc, timeout: int, log_dir: Path):
    """(exit code, every rank's stderr and the launcher's) of a job that
    :func:`start_torchrun` started, killed past ``timeout`` seconds."""
    import subprocess

    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    errs = "".join(p.read_text() for p in sorted(log_dir.rglob("stderr.log")))
    return rc, errs + (log_dir / "launcher.err").read_text()[-4000:]


def mesh_job(d: Path, archs, cfg_of, jax_cfg_of, script: str, seeds=None,
             meshes=MESHES):
    """The inputs (the port's seeded init, a batch from ``seeds[arch]``,
    1 by default), the worker job of four ranks over ``script`` started
    on them, and meanwhile the reference's and the port's one-process
    runs; returns (references, one-process runs, the job's results by
    ``<arch>_<d>x<m>``)."""
    from repro_torch.models import init_params

    inputs = {}
    for arch in archs:
        cfg = cfg_of(arch)
        inputs[arch] = {"arrays": lm_params_to_arrays(init_params(
            cfg, torch.Generator().manual_seed(0), "cpu")),
            "batch": mesh_batch(cfg, seed=(seeds or {}).get(arch, 1))}
        _save(d / f"in_{arch}.npz", inputs[arch])
    job = start_torchrun(4, [script, "worker", str(d)], d / "logs")
    try:
        refs = {a: reference_run(jax_cfg_of(a), **inputs[a]) for a in archs}
        ports = {a: one_process(cfg_of(a), **inputs[a]) for a in archs}
    finally:
        rc, err = finish_torchrun(job, JOB_TIMEOUT, d / "logs")
    assert rc == 0, err[-6000:]
    got = {f"{arch}_{dp}x{mp}": _load(d / f"out_{arch}_{dp}x{mp}.npz")
           for arch in archs for dp, mp in meshes}
    return refs, ports, got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro.configs import get_config as jax_get_config

    d = tmp_path_factory.mktemp("mesh_dense_moe")
    refs, ports, got = mesh_job(d, ARCHS, _cfg, lambda a: _cfg(a, jax_get_config),
                                str(Path(__file__)), SEEDS)
    got["collectives"] = json.loads((d / f"collectives_{COUNTED[0]}.json").read_text())
    return refs, ports, got


CASES = [(arch, f"{dp}x{mp}") for arch in ARCHS for dp, mp in MESHES]


def check_placed(r):
    assert bool(r["init_ok"]) and bool(r["placed_ok"])
    assert bool(r["placed_grads"]) and bool(r["moments_placed"])


def check_loss_and_grads(r, ref, port, what):
    for want in (ref, port):
        assert abs(float(r["loss"]) - want["metrics"]["loss"]) < LOSS_TOL
        for k in ("nll", "aux", "z"):
            assert abs(float(r["metrics"][k]) - want["metrics"][k]) < LOSS_TOL, k
        _assert_leaves(r["grads"], want["grads"], GRAD_TOL, what)
    np.testing.assert_allclose(float(r["gnorm"]), port["gnorm"], rtol=1e-5)


def check_stepped(r, ref, port):
    for want in (ref["stepped"], port["stepped"]):
        g, w = flatten_paths(r["stepped"]), flatten_paths(want)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=PARAM_TOL, err_msg=k)
    np.testing.assert_allclose(r["step_gnorms"], port["step_gnorms"], rtol=1e-5)


def check_widths_keep_placements(cfg, full, mesh):
    """Every leaf of the reduced ``cfg`` is placed on ``mesh`` as the full
    config's leaf of the same name is, and at least one leaf shards over
    each mesh axis the full config shards a leaf over."""
    shape = MeshShape(("data", "model"), mesh)
    mine = param_shardings(cfg, shape, make_rules(cfg))
    theirs = param_shardings(full, shape, make_rules(full))
    for name, sh in mine.items():
        assert sh.spec == theirs[name].spec, (name, sh.spec, theirs[name].spec)
    used = set().union(*(sh.axes_used() for sh in theirs.values()))
    assert used == set().union(*(sh.axes_used() for sh in mine.values()))
    return used


@pytest.mark.parametrize("arch,mesh", CASES)
def test_init_and_state_placed_as_the_rules(runs, arch, mesh):
    """The init is the one-process draw bit for bit, each leaf placed as
    ``tree_shardings`` says with ``shard_shape`` blocks; the gradients and
    the AdamW moments take the same placements."""
    check_placed(runs[2][f"{arch}_{mesh}"])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_loss_and_grads_match_one_process_and_reference(runs, arch, mesh):
    refs, ports, got = runs
    check_loss_and_grads(got[f"{arch}_{mesh}"], refs[arch], ports[arch], arch)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_adamw_steps_match_one_process_and_reference(runs, arch, mesh):
    refs, ports, got = runs
    check_stepped(got[f"{arch}_{mesh}"], refs[arch], ports[arch])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_reduced_widths_keep_the_full_placements(arch, mesh):
    """The reduced widths hide no placement: each leaf's spec is the full
    config's (ZeRO-3 over ``data`` for nemotron and mixtral included)."""
    d, m = map(int, mesh.split("x"))
    used = check_widths_keep_placements(_cfg(arch), get_config(arch), (d, m))
    assert "model" in used
    assert ("data" in used) == get_config(arch).fsdp


def test_routing_has_no_near_tie(runs):
    """In each of mixtral's one-process steps every token's second and
    third router probabilities lie more than 1e-5 apart, far above the
    float32 noise between the mesh and one process (~1e-7): no top-k
    choice can flip between them, so the bars above compare one routing."""
    assert runs[1]["mixtral-8x7b"]["route_gap"] > ROUTE_GAP


def test_features_switched_on():
    """The full configs' features the reduced ones turn off are on:
    ZeRO-3, remat under each config's policy, mixtral's band shorter than
    the sequence and its 16 dispatch groups."""
    for arch in ARCHS:
        cfg, full = _cfg(arch), get_config(arch)
        assert (cfg.fsdp, cfg.remat, cfg.remat_policy, cfg.seq_shard) == (
            full.fsdp, True, full.remat_policy, True)
    assert _cfg("nemotron-4-340b").remat_policy == "dots"
    mix = _cfg("mixtral-8x7b")
    assert mix.attention == "swa" and mix.window * 4 == S and mix.moe_groups == 16


def test_collective_kinds_match_the_dry_run(runs):
    """mixtral's meshed step on 2 x 2 (ZeRO-3 experts, the sequence
    sharded) runs the kinds of collective the dry run counts for the same
    cell, and no other."""
    from repro_torch.launch.dryrun import count_collectives

    arch, mesh = COUNTED
    cfg = _cfg(arch)
    dry = count_collectives(cfg, ShapeSpec("t", S, B, "train"),
                            MeshShape(("data", "model"), mesh), make_rules(cfg), TCFG)
    step = runs[2]["collectives"]
    assert set(step) == {k for k, n in dry["counts"].items() if n}, (step, dry["counts"])


TINY = ["--reduced", "--batch", "8", "--steps", "3", "--log-every", "1",
        "--device", "cpu", "--lr", "1e-3"]
# mixtral's reduced window is 32: a sequence of 64 puts the band inside it
LAUNCHED = [("stablelm-1.6b", "2x2", 16), ("stablelm-3b", "4x1", 16),
            ("nemotron-4-340b", "2x2", 16), ("mixtral-8x7b", "1x4", 64)]


def check_launcher(tmp_path, arch, mesh, seq):
    """The launcher trains the reduced config under
    ``torch.distributed.run`` on the mesh: its losses are one process's
    to 1e-5."""
    from repro_torch.launch import train as launch_train

    argv = ["--arch", arch, *TINY, "--seq", str(seq)]
    whole = launch_train.main(argv)
    d, m = mesh
    rc, _, err = _torchrun(d * m, ["-m", "repro_torch.launch.train", *argv,
                                   "--data-parallel", str(d), "--model-parallel", str(m),
                                   "--metrics-out", str(tmp_path / "m.json")],
                           RUN_TIMEOUT, tmp_path / "logs")
    assert rc == 0, err[-6000:]
    got = json.loads((tmp_path / "m.json").read_text())
    assert [h["step"] for h in got] == [0, 1, 2]
    np.testing.assert_allclose([h["loss"] for h in got], [h["loss"] for h in whole],
                               rtol=0, atol=LOSS_TOL)


@pytest.mark.parametrize("arch,mesh,seq", LAUNCHED)
def test_launcher_trains_on_a_mesh(tmp_path, arch, mesh, seq):
    check_launcher(tmp_path, arch, tuple(map(int, mesh.split("x"))), seq)


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(sys.argv[2])
