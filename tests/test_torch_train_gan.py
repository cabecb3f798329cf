"""The port's PatchGAN discriminators and voxel encoder against the JAX
package's on the same weights: the patch logits, a discriminator update
and the adversarial loss's gradient; the encoder's embeddings and the
EncoderLoss's gradient."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_research import fill_variables, two_torch_threads  # noqa: F401
from v2ce_toolbox_tpu.train import gan as jgan
from v2ce_toolbox_tpu.train import voxel_encoder as jenc
from v2ce_toolbox_tpu_torch.train import gan, voxel_encoder
from v2ce_toolbox_tpu_torch.utils.weights import (
    discriminator_from_jax_params,
    voxel_encoder_from_jax_variables,
)

pytestmark = pytest.mark.usefixtures("two_torch_threads")


@pytest.mark.parametrize("use_3d", [False, True])
def test_discriminator_matches_jax(use_3d):
    """The 2D and 3D PatchGANs on the same weights: patch logits, and one
    `discriminator_update` (gan_k 2 in 2D, 1 in 3D, whose JAX convs take
    longer to compile; the production Adam): d_loss and the
    parameters after it; then, in 2D (the 3D one shares the code past
    `_prep`, checked above), the generator's adversarial loss and its
    gradient with respect to the fake voxels, which leaves the
    discriminator's .grad untouched."""
    rng = np.random.RandomState(6)
    hw = (16, 16) if use_3d else (24, 24)     # 2D: the k4 convs need 24 px
    fake = (rng.rand(1, 1, *hw, 20) * 2).astype(np.float32)
    real = (rng.rand(1, 1, *hw, 20) < 0.2).astype(np.float32)
    jd = jgan.make_discriminator(use_3d)
    x0 = jgan._prep(jnp.asarray(fake), use_3d)
    params = fill_variables(lambda: jd.init(jax.random.key(0), x0), 7)["params"]
    td = gan.make_discriminator(use_3d)
    td.load_state_dict(discriminator_from_jax_params(params))
    want = np.asarray(jax.jit(jd.apply)({"params": params}, x0))
    got = td(gan._prep(torch.from_numpy(fake), use_3d)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)

    gan_k = 1 if use_3d else 2
    update = jax.jit(functools.partial(jgan.discriminator_update, jd, gan_k=gan_k,
                                       use_3d_conv=use_3d))
    jp, _, jdl = update(params, jgan.make_disc_optimizer().init(params), jnp.asarray(fake),
                        jnp.asarray(real))
    tdl = gan.discriminator_update(td, gan.make_disc_optimizer(td.parameters()),
                                   torch.from_numpy(fake), torch.from_numpy(real), gan_k=gan_k,
                                   use_3d_conv=use_3d)
    np.testing.assert_allclose(float(tdl), float(jdl), rtol=1e-5)
    for k, v in discriminator_from_jax_params(jax.tree_util.tree_map(np.asarray, jp)).items():
        np.testing.assert_allclose(td.state_dict()[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    if use_3d:
        return

    jl, jg = jax.jit(jax.value_and_grad(
        lambda f: jgan.generator_adversarial_loss(jd, jp, f, use_3d_conv=use_3d)))(
        jnp.asarray(fake))
    td.zero_grad(set_to_none=True)
    tf = torch.from_numpy(fake).requires_grad_(True)
    tl = gan.generator_adversarial_loss(td, tf, use_3d_conv=use_3d)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    g = np.asarray(jg)
    assert np.abs(tf.grad.numpy() - g).max() <= 1e-4 * np.abs(g).max()
    assert all(p.grad is None for p in td.parameters())
    assert all(p.requires_grad for p in td.parameters())


def test_voxel_encoder_and_encoder_loss_match_jax():
    """VoxelEncoder embeddings and EncoderLoss (value and the gradient
    reaching pred) on the same weights."""
    rng = np.random.RandomState(8)
    x = rng.rand(1, 2, 8, 12, 20).astype(np.float32)
    y = rng.rand(1, 2, 8, 12, 20).astype(np.float32)
    je = jenc.VoxelEncoder()
    variables = fill_variables(lambda: je.init(jax.random.key(0), jnp.asarray(x)), 9)
    sd = voxel_encoder_from_jax_variables(variables)
    te = voxel_encoder.VoxelEncoder()
    te.load_state_dict(sd)
    te.eval()
    want = np.asarray(jax.jit(je.apply)(variables, jnp.asarray(x)))
    got = te(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (1, 2, 512)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    jl_fn = jenc.EncoderLoss(params=variables)
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jl_fn(p, jnp.asarray(y))))(jnp.asarray(x))
    tl_fn = voxel_encoder.EncoderLoss(state_dict=sd)
    tx = torch.from_numpy(x).requires_grad_(True)
    tv = tl_fn(tx, torch.from_numpy(y))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-4)
    g = np.asarray(jg)
    assert np.abs(tx.grad.numpy() - g).max() <= 1e-4 * np.abs(g).max()
    assert all(p.grad is None for p in tl_fn.encoder.parameters())
