"""PyTorch port, sequence parallelism on the training mesh (gloo on the
CPU), as the reference's rules give it: ``make_rules(cfg)`` puts
``"seq"`` on ``model`` for every ``seq_shard`` config.

One ``torch.distributed.run`` job of four ranks runs this file as a
script (``_worker``) and writes what the tests read:

* every ``"seq"`` site (``logical_constraint`` with ``"seq"`` among its
  names) of a meshed forward and training step of reduced qwen2.5-3b,
  deepseek-v2-lite-16b and jamba-v0.1-52b on 2 x 2 and 1 x 4, its result
  placed as ``env_placements`` of the reference's names: ``Shard(1)``
  over ``model``;
* a causal and a sliding-window attention core on sequence-sharded
  queries against one process (float32, the output and each gradient
  within 1e-6 of its largest entry),
  and the same with a planted fault, the mask's rows not offset to the
  rank's block of the queries, which the bar catches;
* the collectives of reduced qwen2.5-3b's meshed step by kind
  (``CommDebugMode``) on 1 x 4 and 2 x 2, against the dry run's
  ``count_collectives`` for the same cell.  Gloo has no all-to-all:
  DTensor runs each as an all-gather and a chunk on the CPU, so the job
  counts those calls as the all-to-alls they are on the card.

The worker's DTensor refuses, as PyTorch 2.11's does,
a view that flattens a sharded dimension other than the first
(``test_torch_mesh_train.strict_views``).  The job has its own timeout.
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

ARCHS = ["qwen2.5-3b", "deepseek-v2-lite-16b", "jamba-v0.1-52b"]
MESHES = [(2, 2), (1, 4)]
B, S = 8, 24
ATTN_TOL = 1e-6
JOB_TIMEOUT = 400
OVER = {"deepseek-v2-lite-16b": {"fsdp": True, "moe_d_ff": 512},
        "jamba-v0.1-52b": {"fsdp": True, "moe_d_ff": 512}}
# the sites each arch's forward must pass: (function, names)
SITES = {
    "qwen2.5-3b": {("Attention.forward", ("batch", "seq", "heads", None)),
                   ("Attention.forward", ("batch", "seq", "kv_heads", None)),
                   ("Attention.forward", ("batch", "seq", None)),
                   ("MLP.forward", ("batch", "seq", "ffn")),
                   ("Block.forward", ("batch", "seq", None)),
                   ("_embed", ("batch", "seq", None)),
                   ("forward_train", ("batch", "seq", "vocab"))},
    "deepseek-v2-lite-16b": {("MLAttention.forward", ("batch", "seq", None)),
                             ("MLP.forward", ("batch", "seq", "ffn")),
                             ("Block.forward", ("batch", "seq", None)),
                             ("_embed", ("batch", "seq", None)),
                             ("forward_train", ("batch", "seq", "vocab"))},
}
SITES["jamba-v0.1-52b"] = SITES["qwen2.5-3b"]
KINDS = {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
         "all_reduce": "all-reduce", "all_to_all_single": "all-to-all",
         "shard_dim_alltoall": "all-to-all"}


def _cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(), **OVER.get(arch, {}))


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}


# ---------------------------------------------------------------------------
# the worker: one process a rank
# ---------------------------------------------------------------------------

def _hook_sites(records):
    """Wrap the models' ``logical_constraint`` to record each ``"seq"``
    site: its function, names, whether its result is placed as
    ``env_placements`` of its names, and whether that puts the sequence
    on ``model``."""
    import repro_torch.models.layers as tl
    import repro_torch.models.model as tm
    from repro_torch.distributed.sharding import env_placements, is_dtensor

    plain = tl.lc

    def hooked(x, *names):
        y = plain(x, *names)
        if "seq" in names and is_dtensor(y):
            want = env_placements(names, tuple(x.shape))
            fn = sys._getframe(1).f_code.co_qualname
            records.append((fn, names, tuple(y.placements) == tuple(want),
                            want[1].is_shard(1)))
        return y

    tl.lc = tm.lc = hooked
    return lambda: setattr(tl, "lc", plain) or setattr(tm, "lc", plain)


def _sites(directory, rank):
    from repro_torch.distributed.sharding import axis_env, distribute_batch, make_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import forward_train, init_params
    from repro_torch.train import TrainConfig, grads_of

    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        batch = _batch(cfg)
        for dp, mp in MESHES:
            mesh = make_host_mesh(dp, mp, device="cpu")
            rules = make_rules(cfg)
            model = init_params(cfg, torch.Generator().manual_seed(7), "cpu", mesh=mesh,
                                rules=rules).requires_grad_(True)
            records = []
            unhook = _hook_sites(records)
            try:
                with axis_env(mesh, rules):
                    forward_train(model, distribute_batch(batch, mesh, rules, "cpu")[
                        "tokens"], cfg)
                    grads_of(model, batch, cfg, TrainConfig(ce_chunk=16))
            finally:
                unhook()
            out[f"{arch}_{dp}x{mp}"] = [[fn, list(n), ok, sh] for fn, n, ok, sh in records]
    if rank == 0:
        (Path(directory) / "sites.json").write_text(json.dumps(out))


def _attention(directory, rank):
    """Causal and sliding-window cores on sequence-sharded queries: the
    largest error of the output and of each gradient against one process,
    each as a share of that tensor's largest entry, sound and with the
    mask's rows left at the top (no offset)."""
    import repro_torch.models.layers as tl
    from repro_torch.distributed.sharding import axis_env, distribute, env_placements, \
        make_rules
    from repro_torch.launch.mesh import make_host_mesh

    cfg = _cfg("qwen2.5-3b")
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    g = torch.Generator().manual_seed(3)
    q, k, v, w = (torch.randn(B, S, n, hd, generator=g) for n in (H, KV, KV, H))
    plain_rows = tl._mask_rows

    def no_offset(mask, q, qp):
        return plain_rows(mask, q, qp) if mask is None else \
            mask[:plain_rows(mask, q, qp).shape[0]]

    out = {}
    for window in (0, 8):
        mask = tl.causal_mask(S, window, "cpu")
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = tl.sdpa(*ins, mask, H // KV)
        want_g = torch.autograd.grad((want * w).sum(), ins)
        for dp, mp in MESHES:
            mesh = make_host_mesh(dp, mp, device="cpu")
            rules = make_rules(cfg)
            for fault in (False, True):
                tl._mask_rows = no_offset if fault else plain_rows
                try:
                    with axis_env(mesh, rules):
                        ds = [distribute(t, mesh, env_placements(names, t.shape))
                              .requires_grad_(True)
                              for t, names in ((q, ("batch", "seq", "heads", None)),
                                               (k, ("batch", "seq", "kv_heads", None)),
                                               (v, ("batch", None, None, None)))]
                        got = tl.sdpa(*ds, mask, H // KV)
                        placed = tuple(got.placements) == tuple(ds[0].placements)
                        got_g = torch.autograd.grad((got * distribute(
                            w, mesh, got.placements)).sum(), ds)
                        err = max(((a.full_tensor() - b).abs().max() / b.abs().max())
                                  .item() for a, b in zip((got, *got_g), (want, *want_g)))
                finally:
                    tl._mask_rows = plain_rows
                out[f"{window}_{dp}x{mp}_{int(fault)}"] = [err, placed]
    if rank == 0:
        (Path(directory) / "attention.json").write_text(json.dumps(out))


def _collectives(directory, rank):
    """Reduced qwen2.5-3b's meshed step: its collectives by kind."""
    import torch.distributed.tensor.placement_types as pt
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed.sharding import axis_env, make_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.train import TrainConfig, grads_of

    cfg = _cfg("qwen2.5-3b")
    calls = []
    plain = pt.shard_dim_alltoall

    def alltoall(*a, **k):      # on the CPU: an all-gather and a chunk
        calls.append(1)
        return plain(*a, **k)

    out = {}
    pt.shard_dim_alltoall = alltoall
    try:
        for dp, mp in MESHES:
            mesh = make_host_mesh(dp, mp, device="cpu")
            rules = make_rules(cfg)
            model = init_params(cfg, torch.Generator().manual_seed(7), "cpu", mesh=mesh,
                                rules=rules).requires_grad_(True)
            calls.clear()
            mode = CommDebugMode()
            with axis_env(mesh, rules), mode:
                grads_of(model, _batch(cfg), cfg, TrainConfig(ce_chunk=16))
            kinds = collections.Counter()
            for op, n in mode.get_comm_counts().items():
                kinds[KINDS[str(op).split(".")[-1]]] += n
            if calls and mesh.device_type == "cpu":
                kinds["all-gather"] -= len(calls)
                kinds["all-to-all"] += len(calls)
            out[f"{dp}x{mp}"] = {k: n for k, n in kinds.items() if n}
    finally:
        pt.shard_dim_alltoall = plain
    if rank == 0:
        (Path(directory) / "collectives.json").write_text(json.dumps(out))


def _worker(directory: str):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from test_torch_mesh_train import strict_views

    strict_views()
    make_host_mesh(1, 1, device="cpu")          # initialises the group
    rank = dist.get_rank()
    for part in (_sites, _attention, _collectives):
        part(directory, rank)
        dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def job(tmp_path_factory):
    from test_torch_mesh_train import _torchrun

    d = tmp_path_factory.mktemp("seq")
    rc, _, err = _torchrun(4, [str(Path(__file__)), "worker", str(d)], JOB_TIMEOUT,
                           d / "logs")
    assert rc == 0, err[-6000:]
    return {name: json.loads((d / f"{name}.json").read_text())
            for name in ("sites", "attention", "collectives")}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
def test_seq_sites_placed_as_the_reference_rules(job, arch, mesh):
    """Every ``"seq"`` site of a meshed forward and training step holds
    its result as ``env_placements`` of the reference's names under
    ``make_rules(cfg)``, the sequence sharded over ``model``; each site
    the arch has is passed."""
    rec = job["sites"][f"{arch}_{mesh}"]
    assert rec and all(ok for _, _, ok, _ in rec), [r for r in rec if not r[2]]
    assert all(seq_on_model for *_, seq_on_model in rec)
    hit = {(fn, tuple(names)) for fn, names, _, _ in rec}
    assert SITES[arch] <= hit, SITES[arch] - hit


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
def test_attention_on_sequence_sharded_queries(job, window, mesh):
    """A causal (window 0) and a sliding-window core on queries sharded
    along the sequence, keys and values gathered: the output and each
    gradient within 1e-6 of one process's largest entry, the output placed
    as the queries."""
    err, placed = job["attention"][f"{window}_{mesh}_0"]
    assert placed and err <= ATTN_TOL, err


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in MESHES])
def test_mask_not_cut_to_the_ranks_rows_fails(job, window, mesh):
    """The planted fault (each rank's mask rows taken from the top, not
    from its block's offset) reads far above the bar."""
    err, _ = job["attention"][f"{window}_{mesh}_1"]
    assert err > 100 * ATTN_TOL, err


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_collective_kinds_match_the_dry_run(job, mesh):
    """The kinds of collective the meshed step runs are the kinds the dry
    run counts for the same cell, and no other."""
    from repro_torch.distributed.sharding import MeshShape, make_rules
    from repro_torch.launch.dryrun import count_collectives

    cfg = _cfg("qwen2.5-3b")
    dry = count_collectives(cfg, ShapeSpec("t", S, B, "train"),
                            MeshShape(("data", "model"), mesh), make_rules(cfg))
    step = job["collectives"][f"{mesh[0]}x{mesh[1]}"]
    assert set(step) == {k for k, n in dry["counts"].items() if n}, (step, dry["counts"])
    assert "all-to-all" in step and "reduce-scatter" in step


def test_dry_run_models_sequence_parallelism():
    """With ``"seq"`` on ``model`` the dry run counts reduce-scatters and
    all-to-alls where the sequence-replicated rules count all-reduces,
    and its docstring no longer lists sequence parallelism as not
    modelled."""
    from repro_torch.distributed.sharding import MeshShape, make_rules
    from repro_torch.launch import dryrun

    cfg = get_config("qwen2.5-3b")
    shape = ShapeSpec("train_4k", 4096, 256, "train")
    mesh = MeshShape(("data", "model"), (16, 16))
    sp = dryrun.count_collectives(cfg, shape, mesh, make_rules(cfg))
    tp = dryrun.count_collectives(cfg, shape, mesh, make_rules(cfg, seq=None))
    assert sp["counts"]["reduce-scatter"] > tp["counts"]["reduce-scatter"]
    assert sp["counts"]["all-to-all"] > 0 == tp["counts"]["all-to-all"]
    assert sp["all-reduce"] < tp["all-reduce"]
    assert "sequence parallelism" not in dryrun.__doc__.split("Not modelled:")[1]


def test_launcher_refuses_a_sequence_that_does_not_divide(monkeypatch):
    """A ``seq_shard`` config's ``--seq`` must divide over the model
    ranks (the rules would leave it whole without a word); the message
    names the rule.  A config without ``seq_shard`` takes it."""
    import torch.distributed as dist

    from repro_torch.launch import train as launch_train

    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match=r'rules\["seq"\] = "model".*--seq 18 does not '
                                         r'divide over 4 model ranks'):
        launch_train.main(["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
                           "--seq", "18", "--model-parallel", "4"])
    assert not dist.is_initialized()
    args = type("Args", (), dict(data_parallel=1, model_parallel=4, batch=8,
                                 microbatches=1, seq=18))
    launch_train._check_mesh_run(args, get_config("mamba2-2.7b").reduced())


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(sys.argv[2])
