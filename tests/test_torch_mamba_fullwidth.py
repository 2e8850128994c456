"""The port's training step against JAX's ``build_train_step`` at the full
width of mamba2-1.3b (d 2048, 64 SSM heads of 64, state 128, one group,
vocab 50280, tied embeddings, remat full), with the depth cut to one layer
so that both packages' weights and Adam state fit the host at float32.
Same weights (``from_jax``), same batches (batch 1 x 256: two 128-row
chunks), the schedule of the on-card train phase (lr 3e-4, warm-up 2, 10
total). The reduced-size tests cannot see a fault that only shows at this
width: the 8512-wide in_proj split, state 128, the 50280-row tied head.

The JAX side runs its plain route (``ssm_impl="ref"``); the port runs the
kernel route, which takes the plain version for host tensors."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data import PipelineConfig, TokenPipeline  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs, convert, optim  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers  # noqa: E402

ARCH = "mamba2-1.3b"
STEPS = 4
# float32 on both sides; the two packages sum in other orders, and Adam's
# first updates carry those last-bit differences into the next step's loss
RTOL = 1e-3


def test_full_width_mamba2_train_steps_match_jax():
    kw = dict(num_layers=1, dtype="float32", remat="full")
    jc = dataclasses.replace(jconfigs.get(ARCH), ssm_impl="ref", **kw)
    tc = dataclasses.replace(configs.get(ARCH), ssm_impl="kernel", **kw)
    assert (tc.d_model, tc.ssm_state, tc.vocab_size, tc.ssm_chunk) == \
        (2048, 128, 50280, 128)
    assert layers.mamba_split(tc) == (4096, 1, 128, 64)
    okw = dict(lr_peak=3e-4, warmup_steps=2, total_steps=10)
    pipe = TokenPipeline(PipelineConfig(vocab_size=jc.vocab_size,
                                        seq_len=256, global_batch=1, seed=0))
    batches = [pipe.batch_at(s) for s in range(STEPS)]

    # JAX first, then the port, so that one package's state is alive at a
    # time
    params = jmodel.init_params(jc, jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    jopt = joptim.AdamWConfig(**okw)
    state = joptim.adamw_init(params, jopt)
    jstep = jax.jit(jtrain.build_train_step(jc, jopt, 1, None))
    want = []
    for b in batches:
        params, state, _, loss, gnorm = jstep(params, state, None, b)
        want.append((float(loss), float(gnorm)))
    del params, state, jstep

    tparams = convert.from_jax(params_np, tc, "cpu")
    del params_np
    topt = optim.AdamWConfig(**okw)
    tstate = optim.adamw_init(dict(tparams.named_parameters()), topt,
                              period=len(tc.pattern))
    tstep = train.build_train_step(tc, topt, 1, None)
    got = []
    for b in batches:
        tparams, tstate, _, loss, gnorm = tstep(
            tparams, tstate, None, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        got.append((float(loss), float(gnorm)))
    # loss and global gradient norm, step by step
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=RTOL)
