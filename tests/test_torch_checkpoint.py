"""PyTorch port, checkpoints on the CPU: the JAX package's five checkpoint
tests mirrored; checkpoints written by either package restored by the
other (bfloat16 leaves included, and a whole training state in the
reference's layout, scan-stacked leaves and optimizer moments); the
port's msgpack writer byte for byte against ``msgpack.packb`` and its
reader on ``msgpack``'s output; zlib and zstd; and the training launcher,
whose run of 6 steps equals 3 steps, a resume and 3 more, bit for bit.
"""
import dataclasses
import io
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models as jmodels
import repro.train as jtrain
import repro.train.checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.convert import flatten_paths, lm_params_to_arrays, opt_state_to_arrays
from repro_torch.launch import train as launch_train
from repro_torch.models import LM
from repro_torch.train import (
    Checkpointer,
    OptConfig,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train import checkpoint as tckpt


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)),
            "h": torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)).bfloat16(),
            "layers": [{"a": torch.from_numpy(rng.normal(size=(4,)))} for _ in range(3)],
        },
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "m": torch.from_numpy(rng.normal(size=(8, 16)))},
    }


def _leaves(tree):
    return flatten_paths(tree)


def _assert_same(a, b):
    fa, fb = _leaves(a), _leaves(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


# -- the reference's five tests, mirrored ------------------------------------

def test_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 10, tree)
    _assert_same(restore_checkpoint(tmp_path, 10, tree), tree)


def test_corruption_detected(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 5, tree)
    man = tmp_path / "step_5" / "manifest.json"
    m = json.loads(man.read_text())
    first = next(iter(m["leaves"]))
    m["leaves"][first]["hash"] = "0" * 32
    man.write_text(json.dumps(m))
    with pytest.raises(IOError, match="corruption"):
        restore_checkpoint(tmp_path, 5, tree)


def test_retention(tmp_path):
    tree = _tree()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, s, tree, keep=2)
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == ["step_4", "step_5"]


def test_latest_and_resume(tmp_path):
    tree = _tree()
    ck = Checkpointer(tmp_path, every=2, keep=5)
    assert ck.resume(tree) == (None, 0)
    ck.maybe_save(2, tree)
    ck.maybe_save(3, tree)  # not saved (every=2)
    ck.maybe_save(4, lambda: tree)   # built only when due
    ck.maybe_save(5, lambda: pytest.fail("built a tree that was not saved"))
    assert latest_step(tmp_path) == 4
    restored, step = ck.resume(tree)
    assert step == 4
    _assert_same(restored, tree)


def test_elastic_restore_onto_a_device(tmp_path):
    """The port's counterpart of the reference's re-sharding: the leaves
    come back on the device asked for, whatever held them before."""
    tree = {"w": torch.arange(32, dtype=torch.float32).reshape(4, 8)}
    save_checkpoint(tmp_path, 1, tree)
    out = restore_checkpoint(tmp_path, 1, tree, device="cpu")
    assert out["w"].device == torch.device("cpu")
    assert torch.equal(out["w"], tree["w"])


# -- more of the port's contract ----------------------------------------------

def test_restore_without_like_and_missing_leaves(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 3, tree)
    _assert_same(restore_checkpoint(tmp_path, 3), tree)
    with pytest.raises(IOError, match="missing"):
        restore_checkpoint(tmp_path, 3, {**tree, "extra": torch.zeros(1)})


def test_async_save_snapshots_before_returning(tmp_path):
    tree = _tree()
    want = {k: v.clone() for k, v in _leaves(tree).items()}
    save_checkpoint(tmp_path, 2, tree, blocking=False)
    with torch.no_grad():
        tree["params"]["w"].add_(1.0)
    for _ in range(200):
        if latest_step(tmp_path) == 2:
            break
        time.sleep(0.05)
    got = _leaves(restore_checkpoint(tmp_path, 2, tree))
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_empty_and_scalar_leaves(tmp_path):
    tree = {"e": torch.zeros((0, 3), dtype=torch.bfloat16),
            "s": torch.tensor(3.5, dtype=torch.float64),
            "b": torch.tensor([True, False])}
    save_checkpoint(tmp_path, 1, tree)
    _assert_same(restore_checkpoint(tmp_path, 1, tree), tree)



@pytest.mark.parametrize("blocking", [True, False])
def test_timings_name_every_part(tmp_path, blocking):
    tree, saved, restored = _tree(), {}, {}
    save_checkpoint(tmp_path, 1, tree, blocking=blocking, timings=saved)
    for _ in range(200):
        if saved:
            break
        time.sleep(0.05)
    assert set(saved) == {"wall_s", "threads", "host_s", "hash_s", "compress_s",
                          "write_s"}
    _assert_same(restore_checkpoint(tmp_path, 1, tree, timings=restored), tree)
    assert set(restored) == {"wall_s", "threads", "read_s", "decompress_s",
                             "hash_s", "place_s"}
    assert all(v >= 0 for v in [*saved.values(), *restored.values()])



def test_pool_starts_items_in_order_and_returns_each_when_done():
    import threading
    lock, state, started = threading.Lock(), {"now": 0, "most": 0}, []

    def fn(i):
        with lock:
            started.append(i)
            state["now"] += 1
            state["most"] = max(state["most"], state["now"])
        time.sleep(0.3 if i == 0 else 0.001)    # the first finishes last
        with lock:
            state["now"] -= 1
        return i

    got = list(tckpt._as_done(fn, range(12), 3))
    assert sorted(got) == list(range(12)) and got[0] != 0
    assert started[:3] == [0, 1, 2] and sorted(started) == list(range(12))
    assert state["most"] <= 3



def test_streamed_save_takes_leaves_as_the_pool_has_room(tmp_path, monkeypatch):
    """A save of (path, leaf) pairs takes each from its generator only
    while the leaves being written hold less than ``STREAM_BYTES``: no
    more than that and one leaf are alive when a leaf is taken.  The
    checkpoint is the tree's, and the JAX package reads its map32 header."""
    import weakref

    monkeypatch.setattr(tckpt, "_workers", lambda: 8)
    monkeypatch.setattr(tckpt, "STREAM_BYTES", 3 * 4096)
    tree = {"params": {f"w{i:02d}": torch.full((1024,), float(i)) for i in range(12)},
            "opt": {"step": torch.tensor(5, dtype=torch.int32)}}
    alive, seen = set(), []

    def pairs():
        for k, v in flatten_paths(tree).items():
            seen.append(len(alive))
            t = v.clone()
            alive.add(k)
            weakref.finalize(t, alive.discard, k)
            yield k, t

    save_checkpoint(tmp_path, 2, pairs())
    assert len(seen) == 13 and max(seen) <= 4, seen
    _assert_same(restore_checkpoint(tmp_path, 2, tree), tree)
    like = {"params": {k: np.zeros(1024, np.float32) for k in tree["params"]},
            "opt": {"step": np.int32(0)}}
    out = jckpt.restore_checkpoint(tmp_path, 2, like)
    assert int(out["opt"]["step"]) == 5
    for k, v in tree["params"].items():
        np.testing.assert_array_equal(np.asarray(out["params"][k]), v.numpy())
    with pytest.raises(ValueError, match="blocking"):
        save_checkpoint(tmp_path, 3, pairs(), blocking=False)


def test_iter_checkpoint_reads_within_its_budget(tmp_path, monkeypatch):
    """``iter_checkpoint`` reads no more leaves at once than its budget
    holds, gives every leaf asked for once, and raises on one it lacks."""
    import threading

    monkeypatch.setattr(tckpt, "_workers", lambda: 8)
    tree = {f"w{i:02d}": torch.full((1024,), float(i)) for i in range(12)}
    save_checkpoint(tmp_path, 1, tree)
    plain, lock, state = tckpt._inflate, threading.Lock(), {"now": 0, "most": 0}

    def counted(*a):
        with lock:
            state["now"] += 1
            state["most"] = max(state["most"], state["now"])
        try:
            yield from plain(*a)
        finally:
            with lock:
                state["now"] -= 1

    monkeypatch.setattr(tckpt, "_inflate", counted)
    got = {k: v.clone() for k, v in tckpt.iter_checkpoint(tmp_path, 1, budget=2 * 4096)}
    _assert_same(got, tree)
    assert 1 <= state["most"] <= 2
    assert [k for k, _ in tckpt.iter_checkpoint(tmp_path, 1, ["w03"])] == ["w03"]
    with pytest.raises(IOError, match="missing leaves"):
        next(tckpt.iter_checkpoint(tmp_path, 1, ["w03", "nope"]))

# -- msgpack -------------------------------------------------------------------

@pytest.mark.parametrize("n_keys,key_len,value_len", [
    (3, 5, 10),          # fixmap, fixstr, bin8
    (20, 31, 255),       # map16, fixstr at its limit, bin8 at its limit
    (2, 32, 256),        # str8, bin16
    (1, 300, 65_536),    # str16, bin32
    (1, 70_000, 3),      # str32
])
def test_packb_is_msgpacks_bytes(n_keys, key_len, value_len):
    rng = np.random.default_rng(n_keys)
    payload = {f"{i:04d}" + "k" * (key_len - 4): rng.bytes(value_len)
               for i in range(n_keys)}
    want = msgpack.packb(payload, use_bin_type=True)
    assert tckpt._packb(payload) == want
    entries = list(tckpt._entries(io.BytesIO(want)))
    assert [k for k, _, _ in entries] == list(payload)
    assert {k: want[o:o + n] for k, o, n in entries} == payload


def test_packb_map32():
    payload = {f"k{i}": b"" for i in range(70_000)}
    assert tckpt._packb(payload) == msgpack.packb(payload, use_bin_type=True)


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_shard_file_is_the_references_payload(tmp_path, codec, monkeypatch):
    """The shard is ``msgpack.packb`` of the compressed leaves, in the
    manifest's codec; the reference's own reader takes it."""
    if codec == "zlib":
        monkeypatch.setattr(tckpt, "zstandard", None)
    tree = _tree()
    save_checkpoint(tmp_path, 1, tree)
    manifest = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert manifest["codec"] == codec
    raw = (tmp_path / "step_1" / "shard_0.msgpack").read_bytes()
    payload = msgpack.unpackb(raw, raw=False)
    assert raw == msgpack.packb(payload, use_bin_type=True)
    # the manifest lists the leaves in the file's order (the order in
    # which the pool finished them)
    assert list(payload) == list(manifest["leaves"])
    assert sorted(payload) == sorted(_leaves(tree))


def test_zstd_checkpoint_without_zstandard_raises(tmp_path, monkeypatch):
    save_checkpoint(tmp_path, 1, _tree())
    monkeypatch.setattr(tckpt, "zstandard", None)
    with pytest.raises(ImportError, match="zstandard"):
        restore_checkpoint(tmp_path, 1, _tree())


def test_zlib_levels_restore_alike(tmp_path, monkeypatch):
    # the port stores (zlib level 0); the reference deflates (level 6)
    monkeypatch.setattr(tckpt, "zstandard", None)
    monkeypatch.setattr(jckpt, "zstandard", None)
    tree = _tree()
    save_checkpoint(tmp_path / "port", 1, tree)
    jckpt.save_checkpoint(tmp_path / "ref", 1, _jax_tree())
    raw = sum(t.numel() * t.element_size() for t in _leaves(tree).values()
              if isinstance(t, torch.Tensor))
    shard = tmp_path / "port" / "step_1" / "shard_0.msgpack"
    assert shard.stat().st_size > raw      # every byte of every leaf stored
    for d in ("port", "ref"):
        assert json.loads((tmp_path / d / "step_1" / "manifest.json").read_text()
                          )["codec"] == "zlib"
        _assert_same(restore_checkpoint(tmp_path / d, 1, tree), tree)
        out = jckpt.restore_checkpoint(tmp_path / d, 1, {"opt": {"step": 0, "m": 0}})
        assert int(out["opt"]["step"]) == 7


# -- across packages -------------------------------------------------------------

def _jax_tree(seed=0):
    t = _tree(seed)
    return {"params": {"w": jnp.asarray(t["params"]["w"].numpy()),
                       "h": jnp.asarray(t["params"]["h"].float().numpy(), jnp.bfloat16),
                       "layers": [{"a": jnp.asarray(lay["a"].numpy())}
                                  for lay in t["params"]["layers"]]},
            "opt": {"step": jnp.int32(7), "m": jnp.asarray(t["opt"]["m"].numpy())}}


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_reference_restores_a_port_checkpoint(tmp_path, codec, monkeypatch):
    if codec == "zlib":
        monkeypatch.setattr(tckpt, "zstandard", None)
    tree = _tree()
    save_checkpoint(tmp_path, 4, tree)
    out = jckpt.restore_checkpoint(tmp_path, 4, _jax_tree())
    assert str(out["params"]["h"].dtype) == "bfloat16"
    flat, want = jax.tree_util.tree_flatten_with_path(out)[0], _leaves(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        np.testing.assert_array_equal(np.asarray(leaf, dtype=np.float64),
                                      want[key].double().numpy())


def test_port_restores_a_reference_checkpoint(tmp_path):
    jckpt.save_checkpoint(tmp_path, 6, _jax_tree())
    out = restore_checkpoint(tmp_path, 6, _tree())
    _assert_same(out, _tree())


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_leaves_in_many_pieces_cross_packages(tmp_path, codec, monkeypatch):
    """Leaves longer than a piece (the piece cut to 1,000 bytes) stream
    through the hash and the codec; either package reads the other's."""
    monkeypatch.setattr(tckpt, "_CHUNK", 1000)
    if codec == "zlib":
        monkeypatch.setattr(tckpt, "zstandard", None)
        monkeypatch.setattr(jckpt, "zstandard", None)
    rng = np.random.default_rng(3)
    tree = {"big": torch.from_numpy(rng.normal(size=(37, 101)).astype(np.float32)),
            "bf": torch.from_numpy(rng.normal(size=(999,)).astype(np.float32)).bfloat16(),
            "zeros": torch.zeros(5000, dtype=torch.float64),
            "small": torch.arange(3, dtype=torch.int32)}
    save_checkpoint(tmp_path / "port", 1, tree)
    _assert_same(restore_checkpoint(tmp_path / "port", 1, tree), tree)
    jax_tree = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) if k == "bf"
                else jnp.asarray(v.numpy()) for k, v in tree.items()}
    out = jckpt.restore_checkpoint(tmp_path / "port", 1, jax_tree)
    for k, v in tree.items():
        np.testing.assert_array_equal(np.asarray(out[k], dtype=np.float64),
                                      v.double().numpy())
    jckpt.save_checkpoint(tmp_path / "ref", 1, jax_tree)
    _assert_same(restore_checkpoint(tmp_path / "ref", 1, tree), tree)


@pytest.fixture(scope="module")
def train_state_reference():
    """The reference's bf16 qwen at 8 layers (scan-stacked) and its AdamW
    state after one step."""
    cfg = dataclasses.replace(jax_get_config("qwen2.5-3b").reduced(), num_layers=8,
                              dtype="bfloat16")
    params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    opt_cfg = OptConfig(lr=1e-3, warmup=1, total_steps=10)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), params)
    params, opt, _ = jax.jit(lambda p, g, o: jtrain.apply_updates(p, g, o, opt_cfg))(
        params, grads, jtrain.init_opt_state(params, opt_cfg))
    return {"params": params, "opt": opt}, opt_cfg


def _port_cfg():
    return dataclasses.replace(get_config("qwen2.5-3b").reduced(), num_layers=8,
                               dtype="bfloat16")


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), tree)


def test_training_state_crosses_packages(tmp_path, train_state_reference):
    """The reference's {"params", "opt"} restored into a port model and
    optimizer; saved again by the port; restored by the reference, equal
    leaf for leaf (bfloat16 parameters, stacked leaves, float32 moments,
    the int32 step)."""
    state, opt_cfg = train_state_reference
    jckpt.save_checkpoint(tmp_path / "ref", 1, state)
    cfg = _port_cfg()
    model = LM(cfg, device="cpu")
    restored, step = Checkpointer(tmp_path / "ref").resume()
    assert step == 1
    opt = launch_train.load_train_state(model, opt_cfg, restored, "cpu")
    assert model.embed.dtype == torch.bfloat16
    jax.tree.map(np.testing.assert_array_equal, lm_params_to_arrays(model),
                 _f32(state["params"]))
    jax.tree.map(np.testing.assert_array_equal, opt_state_to_arrays(opt),
                 _f32(state["opt"]))
    save_checkpoint(tmp_path / "port", 1, launch_train.train_state(model, opt))
    back = jckpt.restore_checkpoint(tmp_path / "port", 1, state)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                            np.asarray(b)), back, state)
    assert jax.tree.map(lambda a: str(a.dtype), back) == \
        jax.tree.map(lambda a: str(a.dtype), state)


def test_load_train_state_refuses_another_optimizer(tmp_path, train_state_reference):
    state, _ = train_state_reference
    jckpt.save_checkpoint(tmp_path, 1, state)
    model = LM(_port_cfg(), device="cpu")
    restored, _ = Checkpointer(tmp_path).resume()
    with pytest.raises(ValueError, match="optimizer"):
        launch_train.load_train_state(model, OptConfig(kind="adafactor"),
                                      restored, "cpu")


# -- the launcher ----------------------------------------------------------------

TINY = ["--arch", "stablelm-1.6b", "--reduced", "--layers", "2", "--vocab", "256",
        "--batch", "4", "--seq", "16", "--log-every", "1", "--device", "cpu"]


def _history(h):
    return [{k: v for k, v in r.items() if k != "elapsed_s"} for r in h]


def test_launcher_resume_is_bit_for_bit(tmp_path, capsys, monkeypatch):
    """6 steps in one call against a call preempted (SIGTERM) after its
    third step, which flushes a checkpoint, and a second call that resumes
    from it: the same history and the same final checkpoint, bit for bit."""
    whole = launch_train.main(TINY + ["--steps", "6", "--ckpt-dir",
                                      str(tmp_path / "a"), "--ckpt-every", "50"])
    plain = launch_train.make_train_step

    def preempted_after_3(*a, **k):
        step, calls = plain(*a, **k), []

        def counted(*args):
            out = step(*args)
            calls.append(1)
            if len(calls) == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return counted

    monkeypatch.setattr(launch_train, "make_train_step", preempted_after_3)
    first = launch_train.main(TINY + ["--steps", "6", "--ckpt-dir",
                                      str(tmp_path / "b"), "--metrics-out",
                                      str(tmp_path / "m.json")])
    monkeypatch.setattr(launch_train, "make_train_step", plain)
    assert latest_step(tmp_path / "b") == 3
    second = launch_train.main(TINY + ["--steps", "6", "--ckpt-dir",
                                       str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "preemption signal" in out and "resumed from step 3" in out
    assert [r["step"] for r in first] == [0, 1, 2]
    assert [r["step"] for r in second] == [3, 4, 5]
    assert _history(first + second) == _history(whole)
    assert _history(json.loads((tmp_path / "m.json").read_text())) == _history(first)
    assert whole[-1]["loss"] < whole[0]["loss"]
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 12 and all(" loss " in ln and " gnorm " in ln for ln in lines)
    assert latest_step(tmp_path / "a") == latest_step(tmp_path / "b") == 6
    a = restore_checkpoint(tmp_path / "a", 6)
    b = restore_checkpoint(tmp_path / "b", 6)
    _assert_same(a, b)
    assert int(a["opt"]["step"]) == 6


def test_launcher_refuses_a_mesh_and_a_missing_card():
    # a mesh of several ranks runs one process a rank, under a launcher
    # (tests/test_torch_mesh_train.py); one process alone refuses it
    with pytest.raises(ValueError, match="mesh takes 2 ranks, one a process"):
        launch_train.main(TINY + ["--data-parallel", "2"])
    with pytest.raises(ValueError, match="mesh takes 2 ranks, one a process"):
        launch_train.main(TINY + ["--model-parallel", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main([a for a in TINY if a not in ("--device", "cpu")])


def test_checkpoint_needs_neither_msgpack_nor_zstandard(tmp_path):
    """With both packages unimportable (as on a machine without them) the
    port's checkpoint writes zlib and reads it back, and never imports
    them."""
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['zstandard'] = None\n"
        "import json, torch\n"
        "from repro_torch.train import save_checkpoint, restore_checkpoint\n"
        f"d = {str(tmp_path)!r}\n"
        "t = {'w': torch.arange(6.0).reshape(2, 3).bfloat16(), 's': torch.tensor(3)}\n"
        "save_checkpoint(d, 1, t)\n"
        "out = restore_checkpoint(d, 1, t)\n"
        "assert all(torch.equal(out[k], t[k]) for k in t)\n"
        "print(json.load(open(d + '/step_1/manifest.json'))['codec'])\n")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "zlib"
