"""Port parity: the CSLS kernel's plain version and ``repro_torch.core.
alignment`` against the JAX package.

The JAX cosine kernel runs as ``tests/test_kernels.py`` runs it on the CPU
(interpret mode). The port's plain version scales raw dot products by
``1/sqrt(Σx²+1e-18)`` of each row, the JAX kernel normalises the rows
first and its oracle divides by ``‖x‖+1e-9``: all agree within 1e-5, and
zero rows give exactly 0. The blockwise ``csls_retrieval_acc`` equals the
full-matrix value; its argmaxes equal the full matrix's up to near-ties.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alignment as jal
from repro.kernels.csls import cosine_matrix as jax_cosine_matrix
from repro.kernels.csls import cosine_matrix_ref as jax_cosine_matrix_ref
from repro.kernels.csls import csls_matrix as jax_csls_matrix
from repro.kge.data import synthesize_universe as jax_universe
from repro_torch.core import alignment as tal
from repro_torch.kernels import csls as tk
from repro_torch.kge.data import synthesize_universe


def _ab(n, m, d, seed=0, zero_rows=False):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = rng.normal(size=(m, d)).astype(np.float32)
    if zero_rows:
        a[n // 2] = 0.0
        b[m - 1] = 0.0
    return a, b


@pytest.mark.parametrize("n,m,d,zero_rows", [(128, 128, 64, False), (200, 150, 32, True),
                                              (64, 257, 100, True), (1, 3, 1, False)])
def test_plain_cosine_matches_jax_kernel_and_refs(n, m, d, zero_rows):
    a, b = _ab(n, m, d, n + m, zero_rows)
    got = tk.cosine_matrix(torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, m)
    jk = np.asarray(jax_cosine_matrix(jnp.asarray(a), jnp.asarray(b), interpret=True))
    for want in (jk, np.asarray(jax_cosine_matrix_ref(jnp.asarray(a), jnp.asarray(b))),
                 np.asarray(jal.cosine_sim(jnp.asarray(a), jnp.asarray(b))),
                 tk.cosine_matrix_ref(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                 tal.cosine_sim(torch.as_tensor(a), torch.as_tensor(b)).numpy()):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if zero_rows:
        assert not bool(got[n // 2].any()) and not bool(got[:, m - 1].any())


@pytest.mark.parametrize("n,m,d,k", [(120, 90, 32, 10), (50, 8, 16, 10), (33, 70, 5, 3)])
def test_csls_matches_jax(n, m, d, k):
    a, b = _ab(n, m, d, 7)
    got = tal.csls(torch.as_tensor(a), torch.as_tensor(b), k).numpy()
    for want in (np.asarray(jax_csls_matrix(jnp.asarray(a), jnp.asarray(b), k=k,
                                            interpret=True)),
                 np.asarray(jal.csls(jnp.asarray(a), jnp.asarray(b), k)),
                 tk.csls_matrix_ref(torch.as_tensor(a), torch.as_tensor(b), k).numpy()):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _rotated(n, d, noise, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return (x @ q).astype(np.float32), (x @ q + noise * rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("block", [64, 7, 1000])
@pytest.mark.parametrize("noise", [0.3, 1.0])
def test_blockwise_retrieval_equals_full_matrix(block, noise):
    """Blocks of 64 and 7 rows (fewer than k) over 300 rows, a ragged last
    block, and one block holding everything; noise 1.0 puts about half the
    argmaxes off the diagonal."""
    x, y = _rotated(300, 12, noise, 3)
    a, b = torch.as_tensor(x), torch.as_tensor(y)
    got = tal.csls_argmax(a, b, 10, block=block)
    want = tk.csls_argmax_ref(a, b, 10)
    full = tk.csls_matrix_ref(a, b, 10)
    rows = torch.arange(300)
    differ = got != want
    gap = (full[rows, got] - full[rows, want]).abs()
    assert bool((gap[differ] <= 1e-5).all())
    acc = tal.csls_retrieval_acc(a, b, 10, block=block)
    assert acc == float((got == rows).double().mean())
    assert abs(acc - float((want == rows).double().mean())) <= int(differ.sum()) / 300
    jacc = jal.csls_retrieval_acc(jnp.asarray(a.numpy()), jnp.asarray(y), 10)
    assert abs(acc - jacc) <= int(differ.sum()) / 300 + 1e-6
    assert acc > 0.9 if noise < 1 else 0.2 < acc < 0.8


def test_csls_identity_best_on_self_and_wrapper_checks():
    a = torch.as_tensor(_ab(50, 1, 16)[0])
    assert tal.csls_retrieval_acc(a, a) > 0.9
    with pytest.raises(ValueError, match="expected a"):
        tk.cosine_matrix(a, a[:, :3])
    assert tal.csls_retrieval_acc(a[:0], a) != tal.csls_retrieval_acc(a[:0], a)  # nan
    tk.reset_launches()
    tk.cosine_matrix(a, a)
    assert tk.LAUNCHES["cosine_matrix"] == 0  # CPU tensors take the plain version


def test_alignment_registry_matches_jax():
    jk = jax_universe(seed=2)
    tkgs = synthesize_universe(seed=2)
    names = ["Yago", "Dbpedia", "Geonames"]
    jreg = jal.AlignmentRegistry.from_kgs({n: jk[n] for n in names})
    treg = tal.AlignmentRegistry.from_kgs({n: tkgs[n] for n in names})
    for a in names:
        assert treg.partners(a) == jreg.partners(a)
        for b in names:
            if a == b:
                continue
            je, te = jreg.entities(a, b), treg.entities(a, b)
            assert (je is None) == (te is None)
            if je is not None:
                assert all(np.array_equal(x, y) for x, y in zip(je, te))
            assert treg.num_aligned(a, b) == jreg.num_aligned(a, b)
    treg.add_relations("Yago", "Dbpedia", [0, 1], [3, 4])
    jreg.add_relations("Yago", "Dbpedia", [0, 1], [3, 4])
    assert treg.num_aligned("Dbpedia", "Yago") == jreg.num_aligned("Dbpedia", "Yago")
    assert np.array_equal(treg.relations("Dbpedia", "Yago")[0], [3, 4])
