"""``repro_torch.models.loss.chunked_cross_entropy`` against the JAX
package's on the same numpy-seeded hidden states, head and labels: chunks
of the default 512 and of 8, lengths the chunk divides and odd ones (the
single-shot fallback), labels of -1 masked, all labels masked; the value
within 1e-6 relative and its gradients within 1e-5 of their largest
magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.loss import chunked_cross_entropy as jce
from repro_torch.models.loss import chunked_cross_entropy


def host(seed, b, s, d, v, masked):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((b, s, d), dtype=np.float32)
    w = (d ** -0.5 * rng.standard_normal((d, v))).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < masked] = -1
    return hidden, w, labels


@pytest.mark.parametrize("s,chunk,masked", [(32, 8, 0.0), (32, 8, 0.3),
                                            (37, 8, 0.3), (21, 512, 0.2),
                                            (16, 8, 1.0)])
def test_chunked_cross_entropy_matches_jax(s, chunk, masked):
    hidden, w, labels = host(s + chunk, 2, s, 16, 40, masked)
    want, (gh, gw) = jax.value_and_grad(
        lambda h, w: jce(h, w, jnp.asarray(labels), chunk=chunk),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(w))
    th, tw = (torch.from_numpy(x).requires_grad_() for x in (hidden, w))
    got = chunked_cross_entropy(th, tw, torch.from_numpy(labels),
                                chunk=chunk)
    assert got.dtype == torch.float32
    if masked == 1.0:
        assert got.item() == float(want) == 0.0
        return
    assert abs(got.item() / float(want) - 1) <= 1e-6
    got_h, got_w = torch.autograd.grad(got, (th, tw))
    for g, j in ((got_h, gh), (got_w, gw)):
        j = np.asarray(j)
        assert np.abs(g.numpy() - j).max() <= 1e-5 * np.abs(j).max()
