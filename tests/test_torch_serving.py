"""PyTorch port, the serving engine on the CPU: ``ServeEngine.generate_batch``
and the dependency-aware ``run`` against the JAX package's engine on the
same parameters (the reference's ``init_params`` through
``repro_torch.convert``), on the cases of ``tests/test_serving.py`` and the
request pattern of ``launch/serve.py`` (every third request extends the
previous one), plus the engine's own contracts: deterministic, a batch row
equal to the prompt alone, the caller's requests never mutated, the card
by default, and the command line.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

import jax

import repro.launch.serve as jserve
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
import repro_torch.launch.serve as tserve
from repro_torch.configs import get_config
from repro_torch.models import LM, init_params
from repro_torch.serving import Request, ServeEngine


def _cfg(registry):
    # tests/test_serving.py's engine: stablelm-1.6b reduced, two layers
    return dataclasses.replace(registry("stablelm-1.6b").reduced(), num_layers=2)


@pytest.fixture(scope="module")
def engines():
    """(reference engine, port engine, cfg) on the reference's parameters."""
    jcfg = _cfg(jax_get_config)
    params = jax_init_params(jcfg, jax.random.PRNGKey(3))
    arrays = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), params)
    cfg = _cfg(get_config)
    return JServeEngine(jcfg, params), ServeEngine(cfg, arrays, device="cpu"), cfg


def _prompts(seed, shape, cfg):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=shape).astype(np.int32)


@pytest.mark.parametrize("seed,shape,max_new", [(0, (3, 12), 6), (1, (2, 10), 5),
                                                (2, (1, 7), 9)])
def test_generate_matches_reference(engines, seed, shape, max_new):
    ref, eng, cfg = engines
    prompts = _prompts(seed, shape, cfg)
    got = eng.generate_batch(prompts, max_new)
    assert got.shape == (shape[0], max_new) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref.generate_batch(prompts, max_new))


def test_generate_deterministic(engines):
    _, eng, cfg = engines
    prompts = _prompts(0, (3, 12), cfg)
    np.testing.assert_array_equal(eng.generate_batch(prompts, 6),
                                  eng.generate_batch(prompts, 6))


def test_generate_matches_unbatched(engines):
    """A batch row equals the prompt alone (no cross-batch leak)."""
    _, eng, cfg = engines
    prompts = _prompts(1, (3, 10), cfg)
    both = eng.generate_batch(prompts, 5)
    for b in range(3):
        np.testing.assert_array_equal(both[b], eng.generate_batch(prompts[b:b + 1], 5)[0])


def _requests(cls, cfg, seed, lengths, parents, max_new=4):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                max_new=max_new, parent=p)
            for i, (n, p) in enumerate(zip(lengths, parents))]


# (lengths, parents): tests/test_serving.py's case; launch/serve.py's six
# requests (every third extends the previous); a chain of three
SCHEDULES = {
    "test_serving": ([8, 8, 4], [None, None, 0]),
    "launch_serve": ([6] * 6, [None, None, 1, None, None, 4]),
    "chain": ([5, 3, 2, 5], [None, 0, 1, None]),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_run_matches_reference(engines, name):
    ref, eng, cfg = engines
    lengths, parents = SCHEDULES[name]
    want = ref.run(_requests(JRequest, cfg, 2, lengths, parents), batch_size=2)
    reqs = _requests(Request, cfg, 2, lengths, parents)
    got = eng.run(reqs, batch_size=2)
    assert set(got) == set(want) == set(range(len(lengths)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
        assert reqs[rid].output is got[rid]
    # the caller's prompts are untouched, and a second run is identical
    assert [len(r.tokens) for r in reqs] == lengths
    again = eng.run(reqs, batch_size=2)
    for rid in got:
        np.testing.assert_array_equal(again[rid], got[rid])
    assert [len(r.tokens) for r in reqs] == lengths


def test_run_serves_children_on_spliced_prompts(engines):
    """Each child is generated after its parent, on the parent's prompt and
    output spliced in front of its own tokens."""
    _, eng, cfg = engines
    lengths, parents = SCHEDULES["chain"]
    reqs = _requests(Request, cfg, 3, lengths, parents)
    calls = []
    plain = eng.generate_batch

    def recording(prompts, max_new):
        out = plain(prompts, max_new)
        calls.append((prompts.copy(), out))
        return out

    eng.generate_batch = recording
    try:
        got = eng.run(reqs, batch_size=4)
    finally:
        del eng.generate_batch
    eff = {}
    for r in reqs:
        eff[r.rid] = (r.tokens if r.parent is None else
                      np.concatenate([eff[r.parent], got[r.parent], r.tokens]))
    served = {}
    for n, (prompts, out) in enumerate(calls):
        for row, o in zip(prompts, out):
            rid = next(i for i, e in eff.items() if np.array_equal(e, row))
            served[rid] = n
            np.testing.assert_array_equal(o, got[rid])
    for r in reqs:
        if r.parent is not None:
            assert served[r.rid] > served[r.parent]
        np.testing.assert_array_equal(eng.generate_batch(eff[r.rid][None], r.max_new)[0],
                                      got[r.rid])


def test_engine_refuses_a_model_it_cannot_serve(engines):
    _, eng, cfg = engines
    with pytest.raises(ValueError, match="built for"):
        ServeEngine(dataclasses.replace(cfg, num_layers=3), eng.model, device="cpu")


def test_card_by_default():
    """``LM``, ``ServeEngine`` and the command line take the card unless
    told otherwise, and raise without one: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = get_config("qwen2.5-3b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "qwen2.5-3b", "--reduced"])
    ServeEngine(cfg, model, device="cpu")


@pytest.mark.parametrize("extra", [[], ["--requests", "6"]])
def test_cli_prints_the_reference_lines(capsys, extra):
    args = ["--arch", "qwen2.5-3b", "--reduced", "--batch", "2", "--prompt-len",
            "8", "--max-new", "4", *extra]
    jserve.main(args)
    want = capsys.readouterr().out.splitlines()
    tserve.main([*args, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == (1 if extra else 2)

    def shape(line):
        return re.sub(r"[0-9.]+", "N", line)

    if extra:
        assert shape(got[0]) == shape(want[0]) and got[0].startswith("6 requests served")
    else:
        assert shape(got[0]) == shape(want[0]) and got[0].startswith("generated (2, 4)")
        assert got[1].startswith("sample: [") and want[1].startswith("sample: [")
