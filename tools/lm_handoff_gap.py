"""Prefill -> decode handoff gap of an LM: the JAX package against the
port's CPU path, on the same weights and prompt.

    PYTHONPATH=src python tools/lm_handoff_gap.py \
        [--arch qwen3-1.7b] [--layers 4] [--batch 2] [--prompt 256]
    PYTHONPATH=src python tools/lm_handoff_gap.py --arch hymba-1.5b \
        --prompt 1100 --dtypes float32
    PYTHONPATH=src python tools/lm_handoff_gap.py --arch internvl2-26b \
        --layers 2 --batch 1 --prompt 264
    PYTHONPATH=src python tools/lm_handoff_gap.py --softcap 1.0

At the arch's full width and a cut depth, the weights are the JAX package's
``init`` (seeded), carried to the port by ``bridge.lm_params_from_numpy``.
For bf16 (the config's dtype) and for float32 (the same weights upcast), each
package computes the logits of a prefill to S and of a prefill to S-1 plus
one decode step of token S-1; the script prints, per package and dtype, the
max |diff| of the two, the max |logit|, and the share of logits outside the
JAX package's own test tolerance (|diff| <= 3e-2 + 3e-2 |logit|), then the
bf16-vs-float32 gap of the prefill logits.  The last line is one JSON object
with these numbers.  It runs on the CPU; at 4 layers of qwen3-1.7b it needs
about 6 GiB.  Cut to 4 layers, xlstm-350m and hymba-1.5b keep every block
kind (``CUTS``, as ``chip_smoke.py`` cuts them): an sLSTM layer at 2, and
global attention at layers 0 and 3 around two windowed ones.  The frontend
archs take their prompt as ``serve`` does: musicgen-medium precomputed
frames (the decoded position a frame), internvl2-26b its patches before
``--prompt`` minus their count text tokens (the last text token decoded);
``--softcap`` sets ``attn_logit_softcap``.
"""
from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import transformer as T

RTOL = ATOL = 3e-2                  # tests/test_models_smoke.py
# a 4-layer cut that keeps every block kind of the recurrent archs
CUTS = {"xlstm-350m": dict(slstm_positions=(2,)),
        "hymba-1.5b": dict(global_attn_positions=(0, 3))}


def prompt(cfg, batch: int, S: int, seed: int) -> dict:
    """The prompt to S as numpy arrays: token ids, or musicgen's frames, or
    InternVL's patches and S - P text tokens."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal((batch, S, cfg.d_model))
                .astype(np.float32)}
    P = cfg.n_frontend_tokens if cfg.frontend == "vision_patches" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, S - P))
           .astype(np.int32)}
    if P:
        out["patches"] = rng.standard_normal((batch, P, cfg.d_model)).astype(
            np.float32)
    return out


def handoff(batch: dict):
    """(the prompt to S-1, the decode input of position S-1, S): the
    patches stay whole, every other input loses its last position."""
    pre = {k: v if k == "patches" else v[:, :-1] for k, v in batch.items()}
    last = {k: v[:, -1:] for k, v in batch.items() if k != "patches"}
    return pre, last, sum(v.shape[1] for v in batch.values())


def jax_logits(cfg, params, batch):
    """(prefill to S, prefill to S-1 + decode S-1) logits, float32 numpy."""
    pre_b, last, S = handoff(batch)
    pre = jax.jit(lambda p, b: JT.prefill(cfg, p, b, S))
    full, _ = pre(params, {k: jnp.asarray(v) for k, v in batch.items()})
    _, caches = pre(params, {k: jnp.asarray(v) for k, v in pre_b.items()})
    dec, _ = jax.jit(lambda p, c, b, i: JT.decode_step(cfg, p, c, b, i))(
        params, caches, {k: jnp.asarray(v) for k, v in last.items()},
        jnp.asarray(S - 1, jnp.int32))
    return np.asarray(full, np.float32), np.asarray(dec, np.float32)


def port_logits(cfg, params, batch):
    pre_b, last, S = handoff(batch)

    def tensors(b):
        return {k: torch.from_numpy(v) for k, v in b.items()}

    with torch.no_grad():
        full, _ = T.prefill(cfg, params, tensors(batch), S)
        _, caches = T.prefill(cfg, params, tensors(pre_b), S)
        dec, _ = T.decode_step(cfg, params, caches, tensors(last), S - 1)
    return full.numpy(), dec.numpy()


def gap(full: np.ndarray, dec: np.ndarray) -> dict:
    d = np.abs(dec.astype(np.float64) - full)
    return {"max_abs_diff": float(d.max()),
            "max_abs_logit": float(np.abs(full).max()),
            "share_outside_ref_tol": float(
                (d > ATOL + RTOL * np.abs(full)).mean())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--softcap", type=float, default=0.0,
                    help="attn_logit_softcap (0: the config's)")
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"],
                    choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)

    cut = dict(n_layers=args.layers,
               **(CUTS.get(args.arch, {}) if args.layers == 4 else {}))
    if args.softcap:
        cut["attn_logit_softcap"] = args.softcap
    jcfg = jget_config(args.arch).replace(**cut)
    tcfg = get_config(args.arch).replace(**cut)
    toks = prompt(jcfg, args.batch, args.prompt, args.seed)
    jp = JT.init(jcfg, jax.random.PRNGKey(args.seed))
    out, prefill = {}, {}
    for dt in args.dtypes:
        if dt != jcfg.dtype:
            jcfg, tcfg = jcfg.replace(dtype=dt), tcfg.replace(dtype=dt)
            jp = jax.tree.map(lambda a: a.astype(dt), jp)
        tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        for pkg, fn, p, c in (("jax", jax_logits, jp, jcfg),
                              ("port_cpu", port_logits, tp, tcfg)):
            full, dec = fn(c, p, toks)
            out[f"{pkg} {dt}"] = gap(full, dec)
            prefill[(pkg, dt)] = full
            print(f"{pkg:8s} {dt:8s}: prefill->decode max |diff| "
                  f"{out[f'{pkg} {dt}']['max_abs_diff']:.4g}, max |logit| "
                  f"{out[f'{pkg} {dt}']['max_abs_logit']:.4g}, share outside "
                  f"{ATOL} + {RTOL} |logit| "
                  f"{out[f'{pkg} {dt}']['share_outside_ref_tol']:.3g}",
                  flush=True)
        del tp
    for pkg in ("jax", "port_cpu") if len(args.dtypes) == 2 else ():
        noise = float(np.abs(prefill[(pkg, "bfloat16")]
                             - prefill[(pkg, "float32")]).max())
        out[f"{pkg} bf16_vs_f32_prefill"] = noise
        print(f"{pkg:8s} max |bf16 - f32| prefill logits {noise:.4g}")
    res = {"arch": args.arch, "layers": args.layers, "batch": args.batch,
           "prompt": args.prompt, "seed": args.seed,
           "softcap": args.softcap, **out}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
