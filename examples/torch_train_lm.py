"""Train a small LM end to end with the PyTorch port's production loop:
config -> AdamW -> checkpoints -> resumable pipeline.

Defaults train a ~14M-param qwen-family model for 200 steps on the card;
``--device cpu`` trains on the host, and any flag of
``repro_torch.launch.train`` overrides the defaults.  Metrics and
checkpoints go under ``build/`` beside ``examples/``; a second run with
the same ``--steps`` resumes from the last checkpoint and takes no step.

  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
"""
import sys
from pathlib import Path

from repro_torch.launch.train import main as train_main

BUILD = Path(__file__).resolve().parents[1] / "build"


def main(argv=None):
    argv = [
        "--arch", "qwen2.5-3b", "--reduced",
        "--layers", "4", "--d-model", "256", "--d-ff", "1024", "--vocab", "4096",
        "--steps", "200", "--batch", "8", "--seq", "128",
        "--lr", "1e-3", "--ckpt-dir", str(BUILD / "torch_train_lm"),
        "--log-every", "20",
        "--metrics-out", str(BUILD / "torch_train_lm_metrics.json"),
    ] + list(sys.argv[1:] if argv is None else argv)
    history = train_main(argv)
    if history:
        first, last = history[0], history[-1]
        print(f"\nloss {first['loss']:.3f} -> {last['loss']:.3f} over "
              f"{last['step'] - first['step']} steps")
        assert last["loss"] < first["loss"], "training must reduce the loss"
    return history


if __name__ == "__main__":
    main()
