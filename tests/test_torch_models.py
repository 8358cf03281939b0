"""The port's CNNs against the reference's at converted params, on the CPU.

Tolerances: logits within 1e-4 absolute; each gradient leaf within 1e-4 of
that leaf's max-abs. XLA and oneDNN sum convolutions in different orders,
so float32 results differ in the last digits. 64 px exercises XLA's
asymmetric SAME padding at stride 2 (stems and MobileNet's stride-2
depthwise blocks); VGG-11 runs at 32 px only, since the reference's VGG-11
has no valid shape between 32 and 224 px (five 2x pools leave 2x2 at 64 px,
while its classifier expects 7x7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.core.simulate import cnn_loss as jcnn_loss
from repro.train.checkpoint import _flatten
from repro_torch import convert
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.core.simulate import cnn_loss

torch.set_num_threads(2)  # the test workers share the CPU with each other

CASES = [
    ("squeezenet1.1", 32), ("squeezenet1.1", 64),
    ("mobilenet-v3-small", 32), ("mobilenet-v3-small", 64),
    ("vgg11", 32),
]


def _reference_params(jcfg, seed):
    """The reference's param pytree, filled from a seeded numpy generator:
    He-normal kernels, and nonzero biases and BatchNorm vectors so that
    their layouts are exercised too."""
    shapes = jax.eval_shape(lambda: jmodels.init_model(jax.random.PRNGKey(0), jcfg))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    rng = np.random.default_rng(seed)
    arrays = []
    for path, sds in leaves:
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "w":
            fan_in = int(np.prod(sds.shape[:-1]))
            a = rng.normal(size=sds.shape) * np.sqrt(2.0 / fan_in)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.normal(size=sds.shape)
        else:
            a = 0.1 * rng.normal(size=sds.shape)
        arrays.append(jnp.asarray(a, jnp.float32))
    return jax.tree_util.tree_unflatten(treedef, arrays)


def _pair(arch, hw, seed=0):
    import dataclasses

    jcfg = dataclasses.replace(jget_config(arch), image_size=hw)
    cfg = dataclasses.replace(get_config(arch), image_size=hw)
    jparams = _reference_params(jcfg, seed)
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    model.load_state_dict(convert.from_jax(_flatten(jparams), device="cpu"))
    rng = np.random.default_rng(seed + 1)
    batch = {
        "images": rng.normal(size=(4, hw, hw, 3)).astype(np.float32),
        "labels": rng.integers(0, 10, size=(4,)).astype(np.int32),
    }
    return jcfg, jparams, cfg, model, batch


def _zero_grad_leaf(arch, path):
    """MobileNet leaves whose exact gradient is 0, so both sides hold only
    rounding noise: conv biases right ahead of a BatchNorm (the batch mean
    cancels them), and ``project_bn/bias``, whose shift reaches the rest of
    the network only through 1x1 convolutions that feed a BatchNorm."""
    if arch != "mobilenet-v3-small":
        return False
    leaf = "/".join(path.split("/")[-2:])
    return leaf in ("stem/b", "head_conv/b", "expand/b", "dw/b", "project/b", "project_bn/bias")


@pytest.mark.parametrize("arch,hw", CASES)
def test_logits_and_grads_match_reference(arch, hw):
    jcfg, jparams, cfg, model, batch = _pair(arch, hw)

    def loss_and_logits(p, b):
        logits, _ = jmodels.forward(p, b, jcfg)
        return jcnn_loss(p, b, jcfg)[0], logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch)
    )
    logits, aux = models.forward(model, batch, cfg)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)
    assert float(aux) == 0.0

    params = {k: v.detach().requires_grad_(True) for k, v in model.named_parameters()}
    images = models.images_to_device(batch["images"], "cpu")
    loss, _ = cnn_loss(model, params, images, torch.from_numpy(batch["labels"].astype(np.int64)))
    loss.backward()
    port = convert.to_jax({k: p.grad for k, p in params.items()})
    ref = _flatten(jgrads)
    assert list(port) == list(ref)  # same leaves, in JAX's flatten order
    largest = max(float(np.abs(g).max()) for g in ref.values())
    for path, g in ref.items():
        if _zero_grad_leaf(arch, path):
            # exact value 0: both sides within 1e-4 of the model's largest gradient
            assert max(np.abs(g).max(), np.abs(port[path]).max()) <= 1e-4 * largest, path
            continue
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(port[path], g, rtol=0, atol=1e-4 * scale, err_msg=path)


@pytest.mark.parametrize("arch", ["squeezenet1.1", "mobilenet-v3-small", "vgg11"])
def test_convert_round_trip_and_layouts(arch):
    jcfg, jparams, cfg, model, _ = _pair(arch, 32, seed=1)
    flat = _flatten(jparams)
    params = convert.from_jax(flat, device="cpu")
    assert sorted(params) == sorted(k for k, _ in model.named_parameters())
    back = convert.to_jax(params)
    assert list(back) == list(flat)
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], np.asarray(arr))
    # layouts: conv HWIO -> OIHW (depthwise (k,k,1,C) -> (C,1,k,k)), linear (in,out) -> (out,in)
    for path, arr in flat.items():
        t = params[convert.torch_name(path)]
        if arr.ndim == 4:
            assert tuple(t.shape) == (arr.shape[3], arr.shape[2], arr.shape[0], arr.shape[1])
        elif arr.ndim == 2:
            assert tuple(t.shape) == arr.shape[::-1]
        else:
            assert tuple(t.shape) == arr.shape
    assert models.param_count(model) == jmodels.param_count(jparams)


def test_same_padding_is_xlas_asymmetric_split():
    from repro_torch.models.cnn import _same_pads

    # stride 2, k=3 on 32 px pads (0, 1); k=5 on 8 px pads (1, 2)
    assert _same_pads(32, 3, 2) == (0, 1)
    assert _same_pads(8, 5, 2) == (1, 2)
    assert _same_pads(32, 3, 1) == (1, 1)


def test_lm_family_is_refused():
    import dataclasses

    # the dense, hybrid and MoE families are ported; the encoder-decoder is not
    cfg = dataclasses.replace(get_config("vgg11"), family="encdec")
    with pytest.raises(NotImplementedError, match="LM side"):
        models.init_model(cfg, generator=torch.Generator(), device="cpu")
