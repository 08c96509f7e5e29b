"""The reference's stub frontend for the port's VLM and audio tests.

The port draws its stand-in patch and frame embeddings from numpy
(``repro_torch.models.frontends``), the reference from ``jax.random``: a
test module that holds the port's VLM or audio models to the reference
takes ``from _torch_modal import reference_frontend  # noqa: F401``, and
while it runs the port's stub returns the reference's draw, converted
through numpy.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.models import frontends as t_frontends  # noqa: E402
from repro_torch.models.layers import torch_dtype  # noqa: E402


def reference_draw(cfg, batch, *, seed=0, dtype=None, device="cuda"):
    """``repro.models.frontends.synth_frontend_embeddings``'s values, as a
    tensor of the port's stub."""
    shape = t_frontends.frontend_embedding_shape(cfg, batch)
    x = np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    return torch.as_tensor(x).to(device=device, dtype=torch_dtype(dtype or cfg.compute_dtype))


@pytest.fixture(scope="module", autouse=True)
def reference_frontend():
    """The port's stub is the reference's draw while the importing module runs."""
    mp = pytest.MonkeyPatch()
    mp.setattr(t_frontends, "synth_frontend_embeddings", reference_draw)
    yield
    mp.undo()
