"""ROADMAP Queue 3's rwkv6 learning-rate watch, settled on the CPU.

At lr 3e-3, the default of both packages' train CLIs, rwkv6-3b's loss
rose after the warmup on the card. Here the reduced rwkv6-3b trains 12
steps at that rate in both packages, from JAX's weights (PRNGKey 0)
carried across, under the CLI's schedule (warmup min(20, steps // 5) = 2
steps, cosine to step 12), on the data pipeline's batches (4 × 32
tokens): every step's loss agrees within 1e-4 relative (float32; 2.2e-5
seen at step 11; the two-step test in ``test_torch_train.py`` holds
1e-5, and AdamW's sign-normalized first updates of near-zero gradients
move later losses a little further). JAX's own loss rises after the
warmup here too (6.57 at step 0, 6.88 at step 4), so a rise at this rate
is the model's, not the port's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build
from repro.train.loop import init_train_state as jax_init_state
from repro.train.loop import make_train_step as jax_train_step
from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import DataIterator
from repro_torch.models import build_model
from repro_torch.train.loop import init_train_state, make_train_step
from torch_parity import to_numpy_tree

STEPS, LR = 12, 3e-3
LOSS_RTOL = 1e-4


def test_rwkv6_at_lr_3e3_trains_as_jax_does():
    kw = dict(lr=LR, warmup_steps=min(20, STEPS // 5), total_steps=STEPS)
    tc, jtc = TrainConfig(**kw), JaxTrainConfig(**kw)
    jcfg = dataclasses.replace(jax_reduced("rwkv6-3b"), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config("rwkv6-3b"), dtype="float32")
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    js = jax_init_state(jparams, jtc)
    ts = init_train_state(convert.params_from_numpy(to_numpy_tree(jparams), "cpu"), tc)
    jstep, tstep = jax.jit(jax_train_step(jm, jtc)), make_train_step(tm, tc)
    data = DataIterator(tcfg, global_batch=4, seq_len=32, seed=0, branch=8)
    jl, tl = [], []
    for i in range(STEPS):
        b = data.batch_at(i)
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tmet = tstep(ts, b)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
