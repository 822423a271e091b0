"""The port's ``TokenStream`` (``repro_torch/data/tokens.py``) against the
JAX package's, bitwise: tokens, labels, audio frames and vision patches for
every frontend, for one worker and for each of two."""
import numpy as np
import pytest

from repro.configs import get_reduced_config as jreduced
from repro.data.tokens import TokenStream as JStream
from repro_torch.configs import get_reduced_config
from repro_torch.data.tokens import TokenStream

ARCHS = ("smollm-360m", "musicgen-medium", "internvl2-26b")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed,worker,n_workers", [(0, 0, 1), (3, 0, 2),
                                                    (3, 1, 2)])
def test_token_stream_is_bitwise_the_jax_packages(arch, seed, worker, n_workers):
    seq = 24 if arch == "internvl2-26b" else 17
    ours = TokenStream(get_reduced_config(arch), seq_len=seq, batch=3,
                       seed=seed, worker=worker, n_workers=n_workers)
    ref = JStream(jreduced(arch), seq_len=seq, batch=3, seed=seed,
                  worker=worker, n_workers=n_workers)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name])
    if arch == "internvl2-26b":        # no loss on the patch positions
        P = get_reduced_config(arch).n_frontend_tokens
        assert (a["labels"][:, :P] == -1).all() and (a["labels"][:, P:] >= 0).all()


def test_workers_draw_different_streams():
    cfg = get_reduced_config("smollm-360m")
    a = next(TokenStream(cfg, seq_len=16, batch=2, seed=1, worker=0, n_workers=2))
    b = next(TokenStream(cfg, seq_len=16, batch=2, seed=1, worker=1, n_workers=2))
    assert not np.array_equal(a["tokens"], b["tokens"])
