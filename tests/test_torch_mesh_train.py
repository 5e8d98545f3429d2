"""PyTorch port, the training step on a mesh of ranks (gloo on the CPU):
reduced qwen2.5-3b (tensor and sequence parallelism over ``model``) and
reduced deepseek-v2-lite-16b (MLA + MoE, experts over ``model``, and
``fsdp`` forced on so that ZeRO-3 sharding over ``data`` runs) on meshes
2x2, 4x1 and 1x4 of four processes, under the reference's rules
(``make_rules(cfg)``: both configs shard the sequence over ``model``),
against the port's one-process step and the
reference's jitted step on the same parameters and batch (GSPMD makes the
reference's meshed step equal to its one-device step in exact
arithmetic).  The worker's DTensor refuses, as PyTorch 2.11's does, a
view that flattens a sharded dimension other than the first
(``strict_views``).

One ``torch.distributed.run`` job of four ranks runs this file as a
script (``_worker``) over every arch and mesh, writing the gathered
results; the tests read them.  Bars, float32: loss 1e-5, each gradient
leaf 1e-4 of its largest entry, parameters after two AdamW steps 2e-3
(those of ``test_torch_train_grads.py``); with int8 compression one
quantum per entry.  The launcher runs under ``torch.distributed.run``: a
2x2 run preempted on one rank flushes its checkpoint from every rank and
resumes on one process; the JAX package's ``restore_checkpoint`` reads
it.  Off a mesh the constraint sites and the local fallbacks are inert,
bit for bit.  Each subprocess has its own timeout.
"""
import dataclasses
import json
import os
import signal
import subprocess
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
    lm_params_from_arrays, lm_params_to_arrays, nest_paths  # noqa: E402
from repro_torch.distributed import fake_quantize_grads  # noqa: E402
from repro_torch.train import OptConfig, TrainConfig, global_norm, grads_of, \
    init_opt_state, make_train_step  # noqa: E402

ARCHS = ["qwen2.5-3b", "deepseek-v2-lite-16b"]
MESHES = [(2, 2), (4, 1), (1, 4)]
B, S = 8, 24
TCFG = TrainConfig(ce_chunk=16)
OPT = OptConfig(lr=1e-3, warmup=1, total_steps=10)
ADAFACTOR = dataclasses.replace(OPT, kind="adafactor")
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 2e-3
JOB_TIMEOUT = 600          # the worker job: every arch on every mesh
RUN_TIMEOUT = 240          # one launcher run


# deepseek keeps its full-size fsdp (reduced() turns it off) and takes an
# expert width of 512, the least that ZeRO-3 shards (sharding_for_spec),
# so that its experts shard over "data" as well as over "model"
OVER = {"qwen2.5-3b": {}, "deepseek-v2-lite-16b": {"fsdp": True, "moe_d_ff": 512}}


def _cfg(arch, registry=get_config, **over):
    return dataclasses.replace(registry(arch).reduced(), **OVER.get(arch, {}), **over)


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}


def _env():
    return {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}


def _torchrun(nproc: int, args: list, timeout: int, log_dir: Path):
    """``python -m torch.distributed.run --standalone`` with each rank's
    output kept under ``log_dir``; returns (exit code, rank 0's stdout,
    every rank's stderr)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "--redirects", "3", "--log-dir",
           str(log_dir), *args]
    proc = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=timeout)
    outs = sorted(log_dir.rglob("stdout.log"))
    errs = "".join(p.read_text() for p in sorted(log_dir.rglob("stderr.log")))
    rank0 = next((p.read_text() for p in outs if p.parent.name == "0"), "")
    return proc.returncode, rank0, errs + proc.stderr[-4000:]


# ---------------------------------------------------------------------------
# the worker: one process a rank, every arch on every mesh
# ---------------------------------------------------------------------------

def strict_views():
    """Make this process's DTensor refuse, as PyTorch 2.11's does, a view
    that flattens a sharded dimension other than the first; 2.13 keeps it
    sharded with a strided placement.  The workers call it first, so that
    the CPU tests hold the meshed step to what PyTorch 2.11 takes.  A
    DTensor without this propagator is left as it is."""
    try:
        from torch.distributed.tensor._ops import _view_ops as vo
        prop = vo._ViewShardingPropagator
        plain = prop._analyze_flatten
    except (ImportError, AttributeError):
        return

    def analyze_flatten(self, cmd):
        if self.strict_view:
            for i, dim in enumerate(cmd.input_dims):
                if i and isinstance(dim, vo.InputDim) and \
                        self._find_plain_shard(dim)[1] is not None:
                    raise RuntimeError(f"a view flattens dimension {dim.input_dim}, "
                                       f"which is sharded (PyTorch 2.11 refuses it)")
        return plain(self, cmd)

    prop._analyze_flatten = analyze_flatten


def _save(path, tree):
    np.savez(path, **{k.replace("/", "|"): np.asarray(v) for k, v in
                      flatten_paths(tree).items()})


def _load(path):
    with np.load(path) as z:
        return nest_paths({k.replace("|", "/"): z[k] for k in z.files})


def _item(t) -> float:
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).item()


def _remat_grads_on_a_thread(model, cfg, batch):
    """Gradients with every layer recomputed in the backward, the backward
    on a thread of its own, as autograd runs it on the card (no context
    variable set there, plain tensors not counted as replicated)."""
    import threading

    from repro_torch.train.train_step import loss_fn

    plain, model.cfg = model.cfg, cfg
    try:
        loss, _ = loss_fn(model, batch, cfg, TCFG)
        out = []
        params = [p for _, p in model.named_parameters()]
        worker = threading.Thread(target=lambda: out.append(
            torch.autograd.grad(loss, params)))
        worker.start()
        worker.join(timeout=RUN_TIMEOUT)
        assert out, "the backward on its own thread did not finish"
        grads = {n: g.redistribute(p.device_mesh, p.placements)
                 for (n, p), g in zip(model.named_parameters(), out[0])}
        return lm_grads_to_arrays(model, grads)
    finally:
        model.cfg = plain


def _worker(directory: str):
    import torch.distributed as dist

    from repro_torch.convert import reference_layout
    from repro_torch.distributed.sharding import MeshSharding, axis_env, \
        distribute_model, make_rules, moment_sharding, param_shardings, spec_of
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params

    strict_views()
    out = Path(directory)
    mesh0 = make_host_mesh(1, 1, device="cpu")   # initialises the group
    del mesh0
    rank = dist.get_rank()
    for arch in ARCHS:
        inp = _load(out / f"in_{arch}.npz")
        cfg = _cfg(arch)
        layout = reference_layout(cfg)
        for dp, mp in MESHES:
            mesh = make_host_mesh(dp, mp, device="cpu")
            rules = make_rules(cfg)
            res = {}
            # the init: the one-process draws bit for bit, placed as the rules say
            sh = param_shardings(cfg, mesh, rules)
            meshed = init_params(cfg, torch.Generator().manual_seed(7), "cpu",
                                 mesh=mesh, rules=rules)
            whole = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
            ref = dict(whole.named_parameters())
            init_ok = placed_ok = True
            for n, p in meshed.named_parameters():
                init_ok &= torch.equal(p.full_tensor(), ref[n])
                placed_ok &= tuple(p.placements) == tuple(sh[n].placements)
                placed_ok &= tuple(p.to_local().shape) == sh[n].shard_shape(p.shape)
            res["init_ok"], res["placed_ok"] = np.array(init_ok), np.array(placed_ok)
            del meshed, whole, ref

            model = distribute_model(lm_params_from_arrays(
                cfg, inp["arrays"], device="cpu"), mesh, rules).requires_grad_(True)
            with axis_env(mesh, rules):
                grads, loss, m = grads_of(model, inp["batch"], cfg, TCFG)
                res["loss"] = np.array(_item(loss))
                res["metrics"] = {k: np.array(_item(v)) for k, v in m.items()}
                res["grads"] = lm_grads_to_arrays(model, grads)
                res["gnorm"] = np.array(global_norm(grads).item())
                res["quantized"] = lm_grads_to_arrays(model, fake_quantize_grads(grads))
                res["placed_grads"] = np.array(all(
                    tuple(grads[n].placements) == tuple(p.placements)
                    for n, p in model.named_parameters()))
                res["thread_grads"] = _remat_grads_on_a_thread(
                    model, dataclasses.replace(cfg, remat=True), inp["batch"])
                mb, _, _ = grads_of(model, inp["batch"], cfg,
                                    dataclasses.replace(TCFG, microbatches=2))
                res["mb_grads"] = lm_grads_to_arrays(model, mb)
                res["mb_float32"] = np.array(all(g.dtype == torch.float32
                                                 for g in mb.values()))
                del grads, mb
                step = make_train_step(cfg, OPT, TCFG)
                opt = init_opt_state(model, OPT)
                params = dict(model.named_parameters())
                res["moments_placed"] = np.array(all(
                    tuple(opt[k][path].placements) == tuple(moment_sharding(
                        MeshSharding(mesh, spec_of(params[names[0]])),
                        stacked).placements)
                    for k in ("m", "v")
                    for path, (names, stacked) in layout.items()))
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
    # Adafactor over scan-stacked leaves (qwen at 8 layers) on 2 x 2
    cfg = _cfg("qwen2.5-3b", num_layers=8)
    inp = _load(out / "in_adafactor.npz")
    mesh = make_host_mesh(2, 2, device="cpu")
    rules = make_rules(cfg)
    model = distribute_model(lm_params_from_arrays(cfg, inp["arrays"], device="cpu"),
                             mesh, rules).requires_grad_(True)
    with axis_env(mesh, rules):
        step = make_train_step(cfg, ADAFACTOR, TCFG)
        opt = init_opt_state(model, ADAFACTOR)
        for _ in range(2):
            model, opt, _ = step(model, opt, inp["batch"])
        res = {"stepped": lm_params_to_arrays(model)}
    if rank == 0:
        _save(out / "out_adafactor.npz", res)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the references: the port's one process and the JAX package's jitted step
# ---------------------------------------------------------------------------

def _jax_np(tree):
    import jax

    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), tree)


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
        (_, _), g = vg(p, batch)
        p, o, _ = apply(p, g, o)
    out["stepped"] = _jax_np(p)
    return out


def _one_process(cfg, arrays, batch, opt=OPT, steps=2):
    """The port's one-process gradients (plain and in 2 microbatches),
    norm, loss and metrics, and parameters after ``steps`` steps."""
    model = lm_params_from_arrays(cfg, arrays, device="cpu").requires_grad_(True)
    grads, loss, m = grads_of(model, batch, cfg, TCFG)
    mb, _, _ = grads_of(model, batch, cfg, dataclasses.replace(TCFG, microbatches=2))
    out = {"metrics": {"loss": loss.item(), **{k: v.item() for k, v in m.items()}},
           "grads": lm_grads_to_arrays(model, grads), "gnorm": global_norm(grads).item(),
           "quantized": lm_grads_to_arrays(model, fake_quantize_grads(grads)),
           "mb_grads": lm_grads_to_arrays(model, mb)}
    step, state, gns = make_train_step(cfg, opt, TCFG), init_opt_state(model, opt), []
    for _ in range(steps):
        model, state, om = step(model, state, batch)
        gns.append(om["grad_norm"].item())
    out.update(stepped=lm_params_to_arrays(model), step_gnorms=gns)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every arch on every mesh in one job of four ranks; the references."""
    d = tmp_path_factory.mktemp("mesh")
    refs, ports = {}, {}
    for arch in ARCHS:
        refs[arch] = _reference(arch)
        _save(d / f"in_{arch}.npz", {"arrays": refs[arch]["arrays"],
                                     "batch": refs[arch]["batch"]})
        ports[arch] = _one_process(_cfg(arch), refs[arch]["arrays"], refs[arch]["batch"])
    cfg8 = _cfg("qwen2.5-3b", num_layers=8)
    arrays8 = lm_params_to_arrays(
        __import__("repro_torch.models", fromlist=["init_params"]).init_params(
            cfg8, torch.Generator().manual_seed(3), "cpu"))
    batch8 = _batch(cfg8, seed=2)
    _save(d / "in_adafactor.npz", {"arrays": arrays8, "batch": batch8})
    ports["adafactor"] = _one_process(cfg8, arrays8, batch8, ADAFACTOR)
    rc, out, err = _torchrun(4, [str(Path(__file__)), "worker", str(d)],
                             JOB_TIMEOUT, d / "logs")
    assert rc == 0, err[-6000:]
    got = {f"{arch}_{dp}x{mp}": _load(d / f"out_{arch}_{dp}x{mp}.npz")
           for arch in ARCHS for dp, mp in MESHES}
    got["adafactor"] = _load(d / "out_adafactor.npz")
    return refs, ports, got


CASES = [(arch, f"{dp}x{mp}") for arch in ARCHS for dp, mp in MESHES]


def _assert_leaves(got, want, rel, what):
    g, w = flatten_paths(got), flatten_paths(want)
    assert g.keys() == w.keys(), what
    for k in w:
        assert g[k].shape == w[k].shape, (what, k)
        top = np.abs(w[k]).max()
        bar = rel * top if top > 0 else 1e-12
        err = np.abs(g[k] - w[k]).max()
        assert err <= bar, (what, k, err, bar)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_init_is_the_one_process_init_placed_by_the_rules(runs, arch, mesh):
    """Each leaf's DTensor holds the one-process draw bit for bit, with
    ``tree_shardings``' placements exactly and ``MeshSharding.shard_shape``
    blocks; the gradients and the AdamW moments take the same placements."""
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


@pytest.mark.parametrize("arch,mesh", CASES)
def test_remat_backward_on_its_own_thread(runs, arch, mesh):
    """Every layer recomputed in the backward, which runs on a thread of
    its own as autograd's device threads do on the card: the gradients of
    the step without remat."""
    _, ports, got = runs
    _assert_leaves(got[f"{arch}_{mesh}"]["thread_grads"], ports[arch]["grads"],
                   GRAD_TOL, arch)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_global_norm_and_microbatches_on_dtensors(runs, arch, mesh):
    """The norm of the whole logical gradient (not of a shard), and two
    microbatches summed in float32, against one process."""
    _, ports, got = runs
    r = got[f"{arch}_{mesh}"]
    np.testing.assert_allclose(float(r["gnorm"]), ports[arch]["gnorm"], rtol=1e-6)
    assert bool(r["mb_float32"])
    _assert_leaves(r["mb_grads"], ports[arch]["mb_grads"], GRAD_TOL, arch)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_compressed_grads_within_one_quantum(runs, arch, mesh):
    """int8 fake quantisation of the reduced gradients: each entry within
    one quantum (the leaf's max / 127) of one process's."""
    _, ports, got = runs
    g = flatten_paths(got[f"{arch}_{mesh}"]["quantized"])
    w = flatten_paths(ports[arch]["quantized"])
    raw = flatten_paths(ports[arch]["grads"])
    for k in w:
        quantum = np.abs(raw[k]).max() / 127.0 + 1e-30
        assert np.abs(g[k] - w[k]).max() <= quantum * (1 + 1e-5), k


def test_adafactor_on_stacked_leaves_matches_one_process(runs):
    """qwen at 8 layers (scan-stacked leaves, factored statistics over
    sharded dimensions) for two Adafactor steps on 2 x 2."""
    _, ports, got = runs
    g, w = flatten_paths(got["adafactor"]["stepped"]), flatten_paths(
        ports["adafactor"]["stepped"])
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=PARAM_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# the launcher under torch.distributed.run
# ---------------------------------------------------------------------------

TINY = ["--arch", "qwen2.5-3b", "--reduced", "--batch", "8", "--seq", "16",
        "--log-every", "1", "--device", "cpu", "--lr", "1e-3"]


def _preempting_launcher(argv, rank: int, after: int):
    """The launcher's ``main`` with rank ``rank`` sending itself SIGTERM
    after its ``after``-th step (the other ranks are not signalled)."""
    from repro_torch.launch import train as launch_train

    plain = launch_train.make_train_step

    def preempted(*a, **k):
        step, calls = plain(*a, **k), []

        def counted(*args):
            out = step(*args)
            calls.append(1)
            if len(calls) == after and int(os.environ["RANK"]) == rank:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return counted

    launch_train.make_train_step = preempted
    launch_train.main(argv)


def _history(text):
    return [ln.split("(")[0].strip() for ln in text.splitlines() if ln.startswith("step ")]


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """6 steps on one process against a 2 x 2 run whose rank 1 is
    preempted after 3 steps, and a one-process run that resumes it."""
    from repro_torch.launch import train as launch_train

    d = tmp_path_factory.mktemp("resume")
    whole = launch_train.main(TINY + ["--steps", "6", "--ckpt-dir", str(d / "a")])
    rc, first, err = _torchrun(4, [str(Path(__file__)), "preempt", json.dumps(
        TINY + ["--steps", "6", "--ckpt-dir", str(d / "b"), "--data-parallel", "2",
                "--model-parallel", "2", "--metrics-out", str(d / "m.json")])],
        RUN_TIMEOUT, d / "logs_b")
    assert rc == 0, err[-6000:]
    rc2, second, err2 = _torchrun(1, ["-m", "repro_torch.launch.train", *TINY,
                                      "--steps", "6", "--ckpt-dir", str(d / "b")],
                                  RUN_TIMEOUT, d / "logs_c")
    assert rc2 == 0, err2[-6000:]
    return d, whole, first, second


def test_mesh_checkpoint_resumes_on_one_process(resumed):
    """Rank 1's signal stops all four ranks after step 3 (a max over the
    ranks), every rank takes part in the flush, rank 0 alone prints and
    writes; one process resumes it for 3 more steps, against 6 steps on
    one process: losses to 1e-5, parameters and moments to 2e-3."""
    from repro_torch.train.checkpoint import latest_step, restore_checkpoint

    d, whole, first, second = resumed
    assert "preemption signal" in first and "resumed from step 3" in second
    assert [ln.split()[1] for ln in first.splitlines() if ln.startswith("step ")] == \
        ["0", "1", "2"]
    lines = [ln for ln in (first + second).splitlines() if ln.startswith("step ")]
    assert len(lines) == 6
    losses = [float(ln.split()[3]) for ln in lines]
    np.testing.assert_allclose(losses, [h["loss"] for h in whole], atol=1e-4)
    logged = json.loads((d / "m.json").read_text())
    np.testing.assert_allclose([h["loss"] for h in logged],
                               [h["loss"] for h in whole[:3]], atol=LOSS_TOL)
    assert latest_step(d / "a") == latest_step(d / "b") == 6
    a = flatten_paths(restore_checkpoint(d / "a", 6))
    b = flatten_paths(restore_checkpoint(d / "b", 6))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k].float().numpy(), a[k].float().numpy(),
                                   rtol=0, atol=PARAM_TOL, err_msg=k)


def test_mesh_checkpoint_resumes_on_another_mesh(resumed, tmp_path):
    """The 2 x 2 run's step-3 checkpoint resumed on a 1 x 4 mesh (each rank
    reading the leaves one by one and keeping its blocks of them) for 3
    more steps, against 6 steps on one process: the printed losses to
    1e-4 (four decimals), parameters and moments to 2e-3."""
    import shutil

    from repro_torch.train.checkpoint import latest_step, restore_checkpoint

    d, whole = resumed[0], resumed[1]
    shutil.copytree(d / "b" / "step_3", tmp_path / "c" / "step_3")
    rc, out, err = _torchrun(4, ["-m", "repro_torch.launch.train", *TINY, "--steps", "6",
                                 "--ckpt-dir", str(tmp_path / "c"), "--model-parallel",
                                 "4"], RUN_TIMEOUT, tmp_path / "logs")
    assert rc == 0, err[-6000:]
    assert "resumed from step 3" in out
    losses = [float(ln.split()[3]) for ln in out.splitlines() if ln.startswith("step ")]
    np.testing.assert_allclose(losses, [h["loss"] for h in whole[3:]], atol=1e-4)
    assert latest_step(tmp_path / "c") == 6
    a = flatten_paths(restore_checkpoint(d / "a", 6))
    c = flatten_paths(restore_checkpoint(tmp_path / "c", 6))
    assert a.keys() == c.keys()
    for k in a:
        np.testing.assert_allclose(c[k].float().numpy(), a[k].float().numpy(),
                                   rtol=0, atol=PARAM_TOL, err_msg=k)


def test_reference_restores_a_mesh_checkpoint(resumed):
    """The 2 x 2 run's step-3 checkpoint, whole logical leaves in the
    reference's layout, restores in the JAX package's restore_checkpoint
    to the port's own restore, bit for bit."""
    from repro.train.checkpoint import restore_checkpoint as jax_restore
    from repro_torch.train.checkpoint import restore_checkpoint

    d = resumed[0]
    mine = flatten_paths(restore_checkpoint(d / "b", 3))
    like = nest_paths({k: v.float().numpy() for k, v in mine.items()})
    theirs = flatten_paths(jax_restore(d / "b", 3, like))
    assert mine.keys() == theirs.keys()
    for k, v in mine.items():
        np.testing.assert_array_equal(np.asarray(theirs[k], dtype=np.float32),
                                      v.float().numpy(), err_msg=k)


def test_launcher_refuses_a_mesh_it_cannot_hold(monkeypatch):
    """Without a launcher a mesh of several ranks is refused, and so is a
    batch that does not divide over the data ranks times the
    microbatches; both before any process group starts."""
    import torch.distributed as dist

    from repro_torch.launch import train as launch_train

    with pytest.raises(ValueError, match="takes 4 ranks"):
        launch_train.main(TINY + ["--data-parallel", "2", "--model-parallel", "2"])
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="does not divide"):
        launch_train.main(TINY + ["--data-parallel", "4", "--microbatches", "4"])
    with pytest.raises(ValueError, match="this run has 4 ranks"):
        launch_train.main(TINY + ["--data-parallel", "2"])
    assert not dist.is_initialized()


def test_off_a_mesh_the_sites_are_inert(monkeypatch):
    """Outside a mesh the constraint sites and the local fallbacks change
    nothing: loss, gradients and logits bit for bit those of the same
    code with every site replaced by the identity (and the fallbacks by
    direct calls)."""
    import repro_torch.models.layers as tl
    import repro_torch.models.model as tm
    import repro_torch.train.train_step as ts
    from repro_torch.models import forward_train, init_params

    def run():
        out = {}
        for arch in ARCHS:
            cfg = _cfg(arch)
            model = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
            model.requires_grad_(True)
            grads, loss, _ = grads_of(model, _batch(cfg), cfg, TCFG)
            with torch.no_grad():
                logits, _ = forward_train(model, _batch(cfg)["tokens"], cfg)
            out[arch] = (loss, grads, logits)
        return out

    hooked = run()
    for mod in (tl, tm, ts):
        monkeypatch.setattr(mod, "lc" if mod is not ts else "logical_constraint",
                            lambda x, *names: x)
    monkeypatch.setattr(tl, "local_fallback", lambda fn, args, *_: fn(*args))
    monkeypatch.setattr(ts, "local_fallback", lambda fn, args, *_: fn(*args))
    bare = run()
    for arch in ARCHS:
        assert torch.equal(hooked[arch][0], bare[arch][0])
        assert torch.equal(hooked[arch][2], bare[arch][2])
        for n, g in hooked[arch][1].items():
            assert torch.equal(g, bare[arch][1][n]), n


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(sys.argv[2])
    elif sys.argv[1] == "preempt":
        _preempting_launcher(json.loads(sys.argv[2]), rank=1, after=3)
