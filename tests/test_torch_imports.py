"""Guards on the PyTorch port's boundary: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, importing the port needs
no CUDA toolkit, and an entry point called without ``device=`` on a machine
without CUDA raises instead of carrying on on the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "examples" / "quickstart_torch.py",
    REPO / "examples" / "federated_11kg_torch.py",
    REPO / "examples" / "distributed_fkge_torch.py", REPO / "examples" / "serve_engine_torch.py",
    REPO / "examples" / "train_lm_torch.py", REPO / "examples" / "federated_lm_embeddings_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "flax", "optax")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_files_exist():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for want in ("chip_smoke.py", "src/repro_torch/serving/tier.py",
                 "src/repro_torch/kernels/triple_score/ops.py",
                 "src/repro_torch/kge/engine.py", "src/repro_torch/kge/trainer.py",
                 "src/repro_torch/kernels/sparse_update/ops.py",
                 "src/repro_torch/kernels/sparse_update/ref.py",
                 "src/repro_torch/core/privacy.py", "src/repro_torch/core/pate.py",
                 "src/repro_torch/core/ppat.py", "src/repro_torch/core/alignment.py",
                 "src/repro_torch/core/aggregation.py",
                 "src/repro_torch/kernels/csls/ops.py", "src/repro_torch/kernels/csls/ref.py",
                 "src/repro_torch/configs/base.py", "src/repro_torch/configs/registry.py",
                 "src/repro_torch/data/pipeline.py", "src/repro_torch/models/layers.py",
                 "src/repro_torch/models/attention.py", "src/repro_torch/models/ssm.py",
                 "src/repro_torch/models/blocks.py", "src/repro_torch/models/model.py",
                 "src/repro_torch/models/moe.py", "examples/serve_engine_torch.py",
                 "src/repro_torch/kernels/flash_attention/ops.py",
                 "src/repro_torch/kernels/flash_attention/ref.py",
                 "src/repro_torch/kernels/ssd_scan/ops.py",
                 "src/repro_torch/kernels/ssd_scan/ref.py",
                 "src/repro_torch/serving/engine.py", "src/repro_torch/launch/serve.py",
                 "src/repro_torch/core/federation.py", "src/repro_torch/core/faults.py",
                 "src/repro_torch/core/adversary.py", "src/repro_torch/core/attacks.py",
                 "src/repro_torch/checkpoint/__init__.py",
                 "src/repro_torch/checkpoint/checkpointer.py",
                 "src/repro_torch/core/tick_engine.py", "src/repro_torch/core/distributed.py",
                 "src/repro_torch/core/parties.py",
                 "examples/quickstart_torch.py", "examples/federated_11kg_torch.py",
                 "examples/distributed_fkge_torch.py",
                 "src/repro_torch/optim/__init__.py", "src/repro_torch/optim/adamw.py",
                 "src/repro_torch/optim/schedule.py", "src/repro_torch/train/__init__.py",
                 "src/repro_torch/train/loss.py", "src/repro_torch/train/step.py",
                 "src/repro_torch/launch/train.py", "examples/train_lm_torch.py",
                 "examples/federated_lm_embeddings_torch.py",
                 "src/repro_torch/sharding/__init__.py", "src/repro_torch/sharding/context.py",
                 "src/repro_torch/sharding/specs.py", "src/repro_torch/sharding/cores.py",
                 "src/repro_torch/sharding/comm.py", "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/launch/workloads.py", "src/repro_torch/launch/dryrun.py",
                 "src/repro_torch/utils/roofline.py", "src/repro_torch/utils/collectives.py"):
        assert want in names
    assert (REPO / "src/repro_torch/kernels/sparse_update/csrc/sparse_step.cu").is_file()
    assert (REPO / "src/repro_torch/kernels/csls/csrc/cosine_matrix.cu").is_file()
    assert (REPO / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu").is_file()
    assert (REPO / "src/repro_torch/kernels/ssd_scan/csrc/ssd_chunks.cu").is_file()
    # every card of the JAX package has its copy in the port
    jax_cards = {p.name for p in (REPO / "src/repro/configs").glob("*.py")}
    assert jax_cards == {p.name for p in (REPO / "src/repro_torch/configs").glob("*.py")}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [(ln, mod) for ln, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_entry_points_without_device_raise_without_cuda(no_cuda):
    from repro_torch.core.distributed import replica_devices
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.kge.models import KGEModel, init_kge, params_from_numpy
    from repro_torch.kge.trainer import KGETrainer
    from repro_torch.serving import KGEServingTier

    m = KGEModel("transe", 10, 2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_kge(0, m)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"ent": np.zeros((10, 4))})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replica_devices(0, 1)
    params = init_kge(0, m, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KGEServingTier(params, m)
    kg = type("KG", (), {"num_entities": 10, "num_relations": 2})()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KGETrainer(kg, dim=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KGETrainer(kg, dim=4, device="cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    from repro_torch.core.ppat import PPATConfig, host_params_from_numpy, train_ppat

    x = np.zeros((8, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ppat(x, x, PPATConfig(steps=1, hidden=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        host_params_from_numpy({"student": {"w1": x}})
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import CausalLM, init_params

    cfg = reduced(get_config("qwen3-0.6b")).replace(dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CausalLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-0.6b", "--reduced"])
    from repro_torch.launch import train as ltrain
    from repro_torch.train import init_train_state

    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(None, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ltrain.main(["--arch", "qwen3-0.6b", "--reduced", "--steps", "1"])
    from repro_torch.core.federation import FederationScheduler
    from repro_torch.kge.data import synthesize_universe

    kgs = synthesize_universe(seed=0, scale=1 / 2000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederationScheduler(kgs, dim=4)
    assert FederationScheduler(kgs, dim=4, device="cpu").device == torch.device("cpu")
    from repro_torch.core import attacks

    rows = {0: np.zeros(4), 1: np.ones(4)}
    tri = np.array([[0, 0, 1]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attacks.membership_inference(rows, tri, tri)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attacks.reconstruction_attack(np.eye(4), np.eye(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attacks.auc(np.ones(3), np.zeros(2))
    assert attacks.auc(np.ones(3), np.zeros(2), device="cpu") == 1.0
    assert attacks.auc(torch.ones(3), np.zeros(2)) == 1.0  # a tensor keeps its device
    from repro_torch.core import distributed

    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.make_party_group(0, 1, backend="gloo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.run_parties(distributed.exchange_party, 2, backend="gloo",
                                init_method="file:///nonexistent")
    with pytest.raises(RuntimeError, match="nccl needs one card per rank"):
        distributed.make_party_group(0, 1, backend="nccl", device="cpu")
    assert distributed.make_party_group(0, 1, backend="gloo", device="cpu").device == \
        torch.device("cpu")


def test_kernel_build_is_lazy():
    """Importing the whole port (in a fresh interpreter) starts no compiler
    and loads no kernel library."""
    code = (
        "import sys; import repro_torch.serving, repro_torch.kge.eval\n"
        "import repro_torch.kge.trainer\n"
        "from repro_torch.kernels.triple_score import ops\n"
        "from repro_torch.kernels.sparse_update import ops as sops\n"
        "from repro_torch.kernels.csls import ops as cops\n"
        "import repro_torch.core.ppat, repro_torch.core.aggregation\n"
        "import repro_torch.core.adversary, repro_torch.core.attacks, repro_torch.checkpoint\n"
        "import repro_torch.models, repro_torch.launch.serve\n"
        "import repro_torch.optim, repro_torch.train, repro_torch.launch.train\n"
        "from repro_torch.kernels.flash_attention import ops as fops\n"
        "from repro_torch.kernels.ssd_scan import ops as kops\n"
        "assert all(lib._lib is None for lib in ops.LIBRARIES + sops.LIBRARIES"
        " + cops.LIBRARIES + fops.LIBRARIES + kops.LIBRARIES)\n"
        "assert 'jax' not in sys.modules and 'triton' not in sys.modules\n"
        "print(ops.PAIRWISE_LIB.path.name, ops.FUSED_RANKS_LIB.path.name,"
        " sops.STEP_LIB.path.name, cops.COSINE_LIB.path.name, fops.FLASH_LIB.path.name,"
        " kops.SSD_LIB.path.name)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")}, timeout=120)
    assert out.returncode == 0, out.stderr
    pair, fused, step, cos, flash, ssd = out.stdout.split()
    assert flash.startswith("libflash_attention-") and ssd.startswith("libssd_chunks-")
    assert cos.startswith("libcsls_cosine-") and cos.endswith(".so")
    assert step.startswith("libsparse_update_step-") and step.endswith(".so")
    assert pair.startswith("libtriple_score_pairwise-") and pair.endswith(".so")
    assert fused.startswith("libtriple_score_fused_ranks-")
