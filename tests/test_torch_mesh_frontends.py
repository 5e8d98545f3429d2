"""PyTorch port, the configs with a frontend stub trained on a mesh of
ranks (gloo on the CPU), with ``remat`` switched back on: reduced
whisper-base (the encoder's bidirectional attention over the ``frames``
extras and the decoder's cross-attention; ``attn_tp`` off, so the heads
stay whole, and no ``seq_shard``) and reduced phi-3-vision-4.2b (the
``patch_embeds`` extras spliced over the first 12 of 32 positions of a
sequence sharded over ``model``: on 1 x 4 the patch rows span two
ranks' blocks) on meshes 2x2, 4x1 and 1x4, the extras sharded with the
batch, against the port's one process and the reference's jitted step
on the same parameters and batch.  Every leaf is placed as the full
config's is on the same mesh.  Bars, float32: loss 1e-5, each gradient
leaf 1e-4 of its largest entry, parameters after two AdamW steps 2e-3
(those of ``test_torch_mesh_train.py``).

One ``torch.distributed.run`` job of four ranks runs this file as a
script (``_worker``): both configs on every mesh, and whisper-base's
step on 2 x 2 with its collectives counted by kind against the dry
run's ``count_collectives``.  The launcher trains both configs on a mesh
under ``torch.distributed.run``.  The worker's DTensor refuses, as
PyTorch 2.11's does, a view that flattens a sharded dimension other than
the first (``strict_views``).  Each subprocess has its own timeout.
"""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.distributed.sharding import MeshShape, make_rules  # noqa: E402
from test_torch_mesh_dense_moe import B, MESHES, S, check_launcher, \
    check_loss_and_grads, check_placed, check_stepped, check_widths_keep_placements, \
    count_kinds, full_features, mesh_job, train_on_meshes  # noqa: E402
from test_torch_mesh_train import TCFG, _load, strict_views  # noqa: E402

ARCHS = ["whisper-base", "phi-3-vision-4.2b"]
# phi's 32 kv heads shard over "model" (a multiple of 16, attention_specs):
# 16 keep that; its patch prefix covers 12 of the 32 positions
OVER = {"whisper-base": {},
        "phi-3-vision-4.2b": dict(num_heads=16, num_kv_heads=16, frontend_tokens=12)}
COUNTED = ("whisper-base", (2, 2))


def _cfg(arch, registry=get_config):
    return full_features(arch, OVER[arch], registry)


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro.configs import get_config as jax_get_config

    d = tmp_path_factory.mktemp("mesh_frontends")
    refs, ports, got = mesh_job(d, ARCHS, _cfg, lambda a: _cfg(a, jax_get_config),
                                str(Path(__file__)))
    got["collectives"] = json.loads((d / f"collectives_{COUNTED[0]}.json").read_text())
    got["gathers"] = json.loads((d / f"gathers_{COUNTED[0]}.json").read_text())
    return refs, ports, got


CASES = [(arch, f"{dp}x{mp}") for arch in ARCHS for dp, mp in MESHES]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_init_and_state_placed_as_the_rules(runs, arch, mesh):
    """The init is the one-process draw bit for bit, each leaf placed as
    ``tree_shardings`` says with ``shard_shape`` blocks; the gradients and
    the AdamW moments take the same placements."""
    check_placed(runs[2][f"{arch}_{mesh}"])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_loss_and_grads_match_one_process_and_reference(runs, arch, mesh):
    """The encoder, the cross-attention and the patch projection's leaves
    among them."""
    refs, ports, got = runs
    check_loss_and_grads(got[f"{arch}_{mesh}"], refs[arch], ports[arch], arch)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_adamw_steps_match_one_process_and_reference(runs, arch, mesh):
    refs, ports, got = runs
    check_stepped(got[f"{arch}_{mesh}"], refs[arch], ports[arch])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_reduced_widths_keep_the_full_placements(arch, mesh):
    """Each leaf's spec on the mesh is the full config's."""
    d, m = map(int, mesh.split("x"))
    assert "model" in check_widths_keep_placements(_cfg(arch), get_config(arch), (d, m))


def test_features_switched_on():
    """remat on; whisper's heads whole and its sequence whole; phi's
    sequence sharded, its patch prefix shorter than the sequence and, on
    1 x 4, across two ranks' blocks of it."""
    whisper, phi = _cfg("whisper-base"), _cfg("phi-3-vision-4.2b")
    assert whisper.remat and phi.remat
    assert make_rules(whisper)["heads"] is None and make_rules(whisper)["seq"] is None
    assert make_rules(phi)["seq"] == "model"
    rows = S // 4
    assert rows < phi.frontend_tokens < 2 * rows


def test_collective_kinds_match_the_dry_run(runs):
    """whisper-base's meshed step on 2 x 2 (heads and sequence whole, the
    encoder's frames sharded with the batch) runs the kinds of collective
    the dry run counts for the same cell, and no other."""
    from repro_torch.launch.dryrun import count_collectives

    arch, mesh = COUNTED
    cfg = _cfg(arch)
    dry = count_collectives(cfg, ShapeSpec("t", S, B, "train"),
                            MeshShape(("data", "model"), mesh), make_rules(cfg), TCFG)
    step = runs[2]["collectives"]
    assert set(step) == {k for k, n in dry["counts"].items() if n}, (step, dry["counts"])


def test_loss_gathers_match_the_dry_run(runs):
    """whisper-base's head shards the vocabulary and its sequence is
    whole, so the loss gathers each chunk's float32 logits over ``model``,
    in the forward and the chunk's recompute: the gathers the step runs,
    by their sizes, are the ones the dry run counts, and their bytes its
    all-gather bytes."""
    from repro_torch.launch.dryrun import count_collectives

    arch, mesh = COUNTED
    cfg = _cfg(arch)
    dry = count_collectives(cfg, ShapeSpec("t", S, B, "train"),
                            MeshShape(("data", "model"), mesh), make_rules(cfg), TCFG)
    gathers = runs[2]["gathers"]       # each gathered along its first dimension
    chunk = (B // mesh[0]) * TCFG.ce_chunk * cfg.padded_vocab * 4
    assert [n for _, n in gathers] == [chunk] * (2 * S // TCFG.ce_chunk), gathers
    assert sum(n for _, n in gathers) == dry["all-gather"]
    assert dry["counts"]["all-gather"] == len(gathers)


@pytest.mark.parametrize("chunk", [16, 12, 64])
def test_loss_gathers_sum_to_the_logits_once_a_pass(chunk):
    """Whatever the chunk (one that divides the sequence, one that leaves
    a remainder, one longer than it), the dry run's loss gathers come to
    the card's float32 logits once in the forward and once in the
    recompute, in two gathers a chunk."""
    import dataclasses

    from repro_torch.launch.dryrun import count_collectives

    arch, mesh = COUNTED
    cfg = _cfg(arch)
    dry = count_collectives(cfg, ShapeSpec("t", S, B, "train"),
                            MeshShape(("data", "model"), mesh), make_rules(cfg),
                            dataclasses.replace(TCFG, ce_chunk=chunk))
    assert dry["all-gather"] == 2 * (B // mesh[0]) * S * cfg.padded_vocab * 4
    assert dry["counts"]["all-gather"] == 2 * -(-S // chunk)


# phi's reduced prefix is 8 positions: a sequence of 16 puts it across two
# of four ranks' blocks
@pytest.mark.parametrize("arch,mesh,seq", [("whisper-base", "2x2", 16),
                                           ("phi-3-vision-4.2b", "1x4", 16)])
def test_launcher_trains_on_a_mesh(tmp_path, arch, mesh, seq):
    """The launcher trains the reduced config, its extras from the
    pipeline, under ``torch.distributed.run`` on the mesh: its losses are
    one process's to 1e-5."""
    check_launcher(tmp_path, arch, tuple(map(int, mesh.split("x"))), seq)


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(sys.argv[2])
