"""One train step under ``kpconv_impl='gather'`` against the JAX
package's: the k-NN maps of sample prep equal, the losses and the
gradients at the gates of tests/test_torch_train.py (see the test's
docstring for the point branch's per-tensor gate)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cofii2p_tpu.data.device_pipeline import prepare_samples as j_prepare
from cofii2p_tpu_torch import train_lib
from cofii2p_tpu_torch.models.kpconv import norm_cancelled_biases
from cofii2p_tpu_torch.models.network import CoFiI2P
from cofii2p_tpu_torch.utils.convert import jax_to_state_dict, load_jax_params
from tests.torch_parity import cfg_pair, host_batch, jax_variables, rel_err, replay_train_draws, to_torch


def test_train_step_gather_matches_jax():
    """One train step under gather: the maps equal JAX's, losses rel 1e-4,
    and the gradients at the rms gate of tests/test_torch_train.py (1e-3
    of a tensor's rms; a bias a one-channel group norm cancels against the
    whole gradient's rms) for every tensor outside the point branch and for
    the point branch's gradient as a whole.

    Tensor by tensor the point branch is held at 1e-2: on this draw
    leaky-ReLU inputs of encoder3_1's and encoder4_3's unary1 and of
    decoder4 lie within 5e-7 (relative to their tensor's rms) of zero,
    inside the two forwards' ~1e-6 difference, so the two sides take
    different slopes there and the gradients upstream move, by up to 5e-3
    for encoder3_1 (a 1e-6 nudge of JAX's own input features can move them
    as much).  The test requires such elements to exist, so the wider
    per-tensor gate stays tied to the cause."""
    from cofii2p_tpu import train_lib as jtl
    from cofii2p_tpu_torch.models.kpconv import UnaryBlock

    step, b = 3, 2
    jcfg, tcfg = cfg_pair("TinyConfig", kpconv_impl="gather")
    hb = host_batch(jcfg, b, start=2)
    jmodel, params, stats = jax_variables(jcfg, hb, seed=2)
    rng = jax.random.PRNGKey(11)
    prep_rng, _ = jax.random.split(jax.random.fold_in(rng, step))
    jbatch = j_prepare(*(jnp.asarray(hb[k]) for k in ("pc", "attrs", "P", "K")), prep_rng,
                       jnp.asarray(hb["img"]), jcfg)

    def loss_fn(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": stats}, jbatch, mode="train", train=True,
                              mutable=["batch_stats"])
        terms = jtl.batch_losses(jcfg, out, jbatch)
        return terms["loss"], terms

    (_, terms), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    ref = jax_to_state_dict(jax.device_get(grads), {})
    tmodel = load_jax_params(CoFiI2P(tcfg), params, stats)
    tbatch = train_lib.prepare_batch(tcfg, to_torch(hb), replay_train_draws(jcfg, rng, step, b))
    for key in ("neighbors", "subsampling", "upsampling"):
        for g, w in zip(tbatch[key], jbatch[key]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=key)
    near_kinks = []

    def near_kink(name):
        def hook(mod, args, out):
            x = out.detach().abs()  # |leaky_relu(x)| >= 0.1 |x|
            if mod.has_relu and bool((x < 1e-6 * x.pow(2).mean().sqrt()).any()):
                near_kinks.append(name)
        return hook

    for name, mod in tmodel.named_modules():
        if isinstance(mod, UnaryBlock):
            mod.register_forward_hook(near_kink(name))
    got = train_lib.loss_fn(tcfg, tmodel, tbatch)
    for key in ("loss", "loss_desc", "loss_coarse", "loss_fine"):
        assert rel_err(got[key], terms[key]) <= 1e-4, key
    got["loss"].backward()
    cancelled = set(norm_cancelled_biases(tmodel))
    rms_all = float(torch.cat([r.flatten() for r in ref.values()]).pow(2).mean().sqrt())
    worst, pc_got, pc_ref = {}, [], []
    for name, prm in tmodel.named_parameters():
        g = (torch.zeros_like(prm) if prm.grad is None else prm.grad).double()
        r = ref[name].double()
        scale = rms_all if name in cancelled else float(r.pow(2).mean().sqrt())
        gate = 1e-2 if name.startswith("pc_encoder.") else 1e-3
        worst[name] = float((g - r).pow(2).mean().sqrt()) / max(scale, 1e-30) / gate
        if name.startswith("pc_encoder.") and name not in cancelled:
            pc_got.append(g.flatten())
            pc_ref.append(r.flatten())
    bad = {k: v for k, v in worst.items() if v > 1.0}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]
    pc_got, pc_ref = torch.cat(pc_got), torch.cat(pc_ref)
    assert float((pc_got - pc_ref).pow(2).mean().sqrt() / pc_ref.pow(2).mean().sqrt()) <= 1e-3
    assert "pc_encoder.encoder3_1.unary1" in near_kinks, near_kinks
    assert max(float(ref[n].abs().max()) for n in ref if n.startswith("pc_encoder")) > 0
