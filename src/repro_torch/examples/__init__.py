"""The JAX package's examples (``examples/*.py``) as entry points of the
port, each run as ``python -m repro_torch.examples.<name>`` with the JAX
example's flags, output table and summary lines, plus two:

  * ``--device`` (default ``cuda``, raising without a card; ``cpu`` runs the
    kernels' plain versions), passed on to the CLIs that the LM examples
    start;
  * ``--reduced``, which gives exactly the JAX example's config.  Without
    it an example runs at full width: Swin-T at 544x800, qwen3-1.7b and
    hymba-1.5b in ``split_serve_lm``, smollm-360m in ``train_lm``.

Weights come from the port's own ``init`` with a seeded generator; nothing
is downloaded.  Each module has ``run(args, ...) -> dict``, which returns
the logs and results (its keywords let a caller bring weights, a
calibration or the estimator's initial parameters of its own), and
``main(argv=None)``, which parses the flags, calls ``run``, prints and
returns.
"""
from __future__ import annotations

import argparse
from pathlib import Path

SEED = 0
SRC = Path(__file__).resolve().parents[2]
ROOT = SRC.parent


def add_port_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--reduced", action="store_true",
                    help="the JAX example's reduced config (default: full "
                         "width)")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (the kernels) or cpu "
                         "(their plain versions)")


def swin_model(args, params=None):
    """(device, Swin config, weights): the JAX example's reduced config
    with ``--reduced``, else full-width Swin-T; weights drawn by the port's
    ``init`` from a generator seeded with SEED unless given."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs.swin_t_detection import CONFIG, reduced
    from repro_torch.models import swin as SW
    dev = resolve_device(args.device)
    cfg = reduced() if args.reduced else CONFIG
    if params is None:
        params = SW.init(cfg, torch.Generator().manual_seed(SEED), device=dev)
    return dev, cfg, params


def frame(video, t: int, dev):
    """Frame ``t`` of a ``SyntheticVideo`` as a (1, H, W, 3) tensor."""
    import torch
    return torch.from_numpy(video.frame(t)[0])[None].to(dev)
