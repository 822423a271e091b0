"""Three steps of the port's ``build_train_step`` against the JAX
package's, on the CPU, for the reduced config of each LM family.

Both start from the JAX package's weights (``T.init`` with a PRNGKey,
carried across by ``bridge.lm_params_from_numpy``) and a fresh AdamW state
and take the same three ``TokenStream`` batches; the JAX step is built as
``tests/test_launch.py`` builds it, on ``make_host_mesh()``.  Per step the
loss, the gradient norm and the learning rate must agree: the learning rate
within LR_TOL (the same float32 schedule), the first step's loss and norm
within STEP1_TOL (the gradients agree to about 1e-5 of their max,
``tests/test_torch_train.py``), and the later steps' within STEP_TOL
relative: after one step AdamW moves each parameter by lr sign(g), so a
gradient element within a few ulps of 0 whose sign differs between the two
sides moves that parameter by 2 lr, and the later steps see slightly
different weights.  Readings: the first step within 7e-7, the later ones
within 2.8e-5 (xLSTM's gradient norm), every other config within 7e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.configs.base import InputShape as JShape
from repro.data.tokens import TokenStream as JStream
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_train_step as jbuild
from repro.models import transformer as JT
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.launch.steps import build_train_step
from repro_torch.optim.adamw import AdamW

ARCHS = ("smollm-360m", "qwen3-1.7b", "granite-moe-3b-a800m",
         "deepseek-v2-lite-16b", "hymba-1.5b", "xlstm-350m",
         "musicgen-medium", "internvl2-26b")
LR_TOL = 1e-6
STEP1_TOL = 1e-5
STEP_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=3)
CPU = torch.device("cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_the_jax_package(arch):
    S = 40 if arch in ("hymba-1.5b", "internvl2-26b") else 24
    jcfg, tcfg = jreduced(arch), get_reduced_config(arch)
    jp = JT.init(jcfg, jax.random.PRNGKey(11))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    batches = [next(s) for s in [JStream(jcfg, seq_len=S, batch=2, seed=2)]
               for _ in range(3)]
    mesh = make_host_mesh()
    jopt, opt = JAdamW(**OPT), AdamW(**OPT)
    jstep = jbuild(jcfg, mesh, JShape("t", S, 2, "train"), opt=jopt).jit()
    step = build_train_step(tcfg, InputShape("t", S, 2, "train"), opt=opt)
    jst, st = jopt.init(jp), opt.init(params)
    for i, b in enumerate(batches):
        with mesh:
            jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in b.items()})
        params, st, m = step(params, st, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
        tol = STEP1_TOL if i == 0 else STEP_TOL
        for key in ("loss", "grad_norm", "lr"):
            want, got = float(jm[key]), float(m[key])
            lim = LR_TOL if key == "lr" else tol
            assert abs(got - want) <= lim * abs(want), (i, key, got, want)
