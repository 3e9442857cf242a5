"""The port's sharding rules, workload shapes and analytic roofline terms
(``repro_torch.sharding.specs``, ``launch.workloads``, ``utils.roofline``)
against the JAX package's, for every card.

The reference's trees come from ``jax.eval_shape`` (no devices, no
arrays); the port's from ``CausalLM(cfg, device="meta")`` through
``models.lm_tree``. Specs are compared as tuples leaf for leaf; the
analytic FLOPs and bytes exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from jax.tree_util import tree_flatten_with_path

from repro.configs import registry as jreg
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.launch import workloads as jwl
from repro.models.model import init_cache as j_init_cache
from repro.models.model import init_params as j_init_params
from repro.sharding import specs as jspecs
from repro.train.step import init_train_state as j_init_train_state
from repro.utils import roofline as jroof
from repro_torch.configs import registry as treg
from repro_torch.configs.base import INPUT_SHAPES as T_SHAPES
from repro_torch.launch import workloads as twl
from repro_torch.models.blocks import layout
from repro_torch.models.model import CausalLM, lm_tree
from repro_torch.sharding import specs as tspecs
from repro_torch.utils import roofline as troof

ARCHS = sorted(jreg.ARCHS)
PAIRS = [(a, s.name) for a in ARCHS for s in J_SHAPES]
KEY = jax.ShapeDtypeStruct((2,), jnp.uint32)


def _spec(p):
    return tuple(p)


def _jax_leaves(tree):
    """{path string: spec tuple} of a reference spec tree."""
    leaves, _ = tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {jax.tree_util.keystr(path): _spec(p) for path, p in leaves}


def _torch_leaves(tree, prefix=""):
    """The port's spec tree in the same path notation."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_torch_leaves(v, f"{prefix}[{k!r}]"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_torch_leaves(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = tuple(tree)
    return out


@pytest.fixture(scope="module")
def models():
    return {a: CausalLM(treg.get_config(a), device="meta") for a in ARCHS}


@pytest.mark.parametrize("layout_", ["tp", "dp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_match_the_reference(models, arch, layout_):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    jparams = jax.eval_shape(lambda k: j_init_params(k, jcfg), KEY)
    tree = lm_tree(tcfg, models[arch], "spec")
    want = _jax_leaves(jspecs.param_pspecs(jparams, layout=layout_))
    got = _torch_leaves(tspecs.param_specs(tree, layout=layout_))
    assert got == want
    jstate = jax.eval_shape(lambda k: j_init_train_state(k, jcfg), KEY)
    js = jspecs.state_pspecs(jstate, layout=layout_)
    ts = tspecs.state_specs(tree, layout=layout_)
    assert _torch_leaves(ts["params"]) == _jax_leaves(js.params)
    assert _torch_leaves(ts["opt"]["mu"]) == _jax_leaves(js.opt.mu)
    assert _torch_leaves(ts["opt"]["nu"]) == _jax_leaves(js.opt.nu)
    assert ts["opt"]["step"] == _spec(js.opt.step)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1-pod", "2-pod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_the_reference(models, arch, multi_pod):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    _, period, _ = layout(tcfg)
    for layout_ in ("tp", "dp"):
        assert tspecs.batch_spec(multi_pod, layout=layout_) == _spec(
            jspecs.batch_pspec(multi_pod, layout=layout_))
    for batch in (1, 2, 128):
        jcache = jax.eval_shape(lambda: j_init_cache(jcfg, batch, 64))
        want = jspecs.cache_pspecs(jcache, jcfg, batch, multi_pod=multi_pod)["layers"]
        with torch.device("meta"):
            tcache = models[arch].init_cache(batch, 64)
        got = tspecs.cache_specs(tcache, tcfg, batch, multi_pod=multi_pod)["layers"]
        assert len(got) == tcfg.num_layers
        for i, layer in enumerate(got):
            assert _torch_leaves(layer) == _jax_leaves(want[i % period]), (batch, i)


def test_placements_follow_the_port_layout():
    """A stacked spec loses its repeat axis, a transposed matrix its order,
    and a dim split over two axes is split by each in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert tspecs.placements((None, None, "model"), Mesh, stacked=True, transposed=True) == (
        Replicate(), Replicate(), Shard(0))
    assert tspecs.placements((("pod", "data"), None), Mesh) == (Shard(0), Shard(0), Replicate())
    assert tspecs.placements((None, None, ("pod", "data", "model")), Mesh) == (
        Shard(2), Shard(2), Shard(2))
    with pytest.raises(ValueError, match="order"):
        tspecs.placements((("data", "pod"),), Mesh)


def test_supported_and_input_specs_match_the_reference():
    assert [s.name for s in T_SHAPES] == [s.name for s in J_SHAPES]
    n_ok = 0
    for arch, shape in PAIRS:
        jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
        js = next(s for s in J_SHAPES if s.name == shape)
        ts = next(s for s in T_SHAPES if s.name == shape)
        ok = twl.supported(tcfg, ts)
        assert ok == jwl.supported(jcfg, js)
        n_ok += ok[0]
        want = jwl.input_specs(jcfg, shape)
        got = twl.input_specs(tcfg, shape)
        assert list(got) == list(want), (arch, shape)
        for k, v in want.items():
            assert got[k].shape == tuple(v.shape), (arch, shape, k)
            assert str(got[k].dtype).removeprefix("torch.") == np.dtype(v.dtype).name
        for mp in (False, True):
            jt = jwl.default_train_config(jcfg, js, multi_pod=mp)
            tt = twl.default_train_config(tcfg, ts, multi_pod=mp)
            assert (tt.global_batch, tt.seq_len, tt.microbatches, tt.ce_chunk) == (
                jt.global_batch, jt.seq_len, jt.microbatches, jt.ce_chunk)
    assert n_ok == 33


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_roofline_terms_match_the_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for js, ts in zip(J_SHAPES, T_SHAPES):
        assert troof.model_flops(tcfg, ts) == jroof.model_flops(jcfg, js)
        assert troof.analytic_cost(tcfg, ts) == jroof.analytic_cost(jcfg, js)
        assert troof._cache_bytes(tcfg, 2, ts.seq_len, 2) == jroof._cache_bytes(
            jcfg, 2, js.seq_len, 2)


def test_roofline_terms_use_the_h100_rates():
    """The corrected terms are the analytic cost over the data-sheet rates,
    the collectives over the link a 16-wide axis crosses (InfiniBand)."""
    cfg = treg.get_config("qwen3-0.6b")
    shape = next(s for s in T_SHAPES if s.name == "train_4k")
    res = {"cost": {"flops": 1e12, "bytes_accessed": 1e9},
           "collectives": {"total": 5e9}}
    r = troof.roofline_terms(cfg, shape, res, chips=256)
    flops, hbm = troof.analytic_cost(cfg, shape)
    assert r["compute_s"] == flops / 256 / 989e12
    assert r["memory_s"] == hbm / 256 / 3.35e12
    assert r["collective_s"] == 5e9 / 50e9 and r["link_bytes_per_s"] == 50e9
    assert r["compute_s_raw"] == 1e12 / 989e12
    assert troof.link_bandwidth(8) == 450e9
    assert troof.peak_rates("NVIDIA H100 80GB HBM3").bf16 == 989e12
