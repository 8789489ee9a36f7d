"""The port's backbone zoo against the JAX package's, on the CPU: the 25
keys and their parameter trees (``tests/test_torch_port_zoo_numerics.py``
holds each family's numbers, ``tests/test_torch_port_zoo_model.py`` the
whole model on them).

- Shapes, all 25 keys: ``jax.eval_shape`` of the flax init (no FLOPs) against
  the port's ``state_dict`` through ``weights.flax_to_state_dict``, which
  raises on a flax leaf that maps nowhere or twice, on a shape that does not
  fit and on a port entry left over; the parameter counts and the C1..C5
  widths are equal.
- relu6's gradient at its bounds: 0 at both 0 and 6, as JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tf2_tpu.models import backbone_names as jax_backbone_names
from maskrcnn_tf2_tpu.models import get_backbone as jax_get_backbone

from maskrcnn_tf2_tpu_torch.models.backbones.factory import backbone_names, get_backbone
from maskrcnn_tf2_tpu_torch.models.layers import relu6
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict

LEVELS = ("C1", "C2", "C3", "C4", "C5")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_backbone_names_are_the_jax_packages():
    assert backbone_names() == list(jax_backbone_names())
    assert len(backbone_names()) == 25


@pytest.mark.parametrize("name", jax_backbone_names())
def test_parameter_tree_matches_flax(name):
    jnet = jax_get_backbone(name, dtype=jnp.float32)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    ends, shapes = jax.eval_shape(lambda r: jnet.init_with_output({"params": r}, x, train_bn=False),
                                  jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    with torch.device("meta"):
        tnet = get_backbone(name)
    sd = flax_to_state_dict(zeros, tnet)  # raises on any leaf or entry that does not map one to one
    assert len([k for k in sd if not k.endswith("num_batches_tracked")]) == len(jax.tree.leaves(shapes))
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in tnet.parameters()) == n_flax
    assert tnet.endpoint_channels == tuple(ends[k].shape[-1] for k in LEVELS[1:])


def test_relu6_gradient_is_zero_at_both_bounds_as_in_jax():
    x = np.asarray([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)
    want = np.asarray(jax.vmap(jax.grad(jax.nn.relu6))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    relu6(t).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    np.testing.assert_array_equal(want, [0.0, 0.0, 1.0, 0.0, 0.0])
