"""Data-parallel training over processes: `init_distributed` on
``torch.distributed`` (gloo, the CPU), a mesh whose data axis spans two
processes, and ``cli.train --devices 2`` under torchrun.

Each run starts its processes with `subprocess` and bounds them with a
timeout, so a hang fails the test.  The graphs are the port's own
(make_synthetic_dataset at 64 px, n_segments=40), ResGCNNet and
GCNTrimapNet at D=16, n_layers=2, fp32.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gcn_grabcut_torch.cli import train as ttrain
from gcn_grabcut_torch.data.dataset import (make_synthetic_dataset,
                                            prepare_dataset)
from gcn_grabcut_torch.graph_build import SuperpixelGraphConfig
from gcn_grabcut_torch.parallel.mesh import (init_distributed, make_mesh,
                                             process_count)
from gcn_grabcut_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
PARAM_TOL = 1e-6           # two processes against one process of two ranks
DP_LOSS_RTOL = 2e-4        # JAX's data-parallel bars (see
DP_SCORE_RTOL, DP_SCORE_ATOL = 2e-3, 2e-4   # test_torch_data_parallel.py)
CFG = dict(n_epochs=1, batch_size=2, bf16=False, verbose=False,
           save_every=100, seed=5, prior_dropout=0.2)
MODEL_KW = dict(hidden_channels=16, n_layers=2)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def child_env() -> dict:
    """The environment of a process the tests start: this checkout and
    the tests on its path, one OpenMP thread."""
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "tests")]))


def train_two_steps(mesh, graphs, save_dir, variant="resgcn") -> Trainer:
    tr = Trainer(variant, dict(MODEL_KW), TrainConfig(**CFG),
                 save_dir=save_dir, mesh=mesh)
    tr.fit(graphs[:4], graphs[4:6])           # batch 2: two steps
    return tr


def worker(rank: int, world: int, port: int, tmp: str,
           variant: str = "resgcn") -> None:
    """One process of the job: join, check that a second join returns
    quietly, train two steps, save the parameters and statistics."""
    torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", num_processes=world,
                     process_id=rank, device="cpu")
    init_distributed(f"localhost:{port}", num_processes=world,
                     process_id=rank, device="cpu")
    assert process_count() == world
    graphs = torch.load(Path(tmp) / "graphs.pt", weights_only=False)
    mesh = make_mesh(n_data=world, devices=["cpu"])
    assert mesh.local_data == 1 and mesh.data_offset == rank
    tr = train_two_steps(mesh, graphs, Path(tmp) / "ckpt", variant)
    torch.save({k: v.detach() for k, v in tr.model.state_dict().items()},
               Path(tmp) / f"state{rank}.pt")
    import torch.distributed as dist
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def graphs():
    samples = make_synthetic_dataset(n=6, size=64, seed=11)
    return [r[0] for r in prepare_dataset(
        samples, SuperpixelGraphConfig(n_segments=40), keep_segments=False,
        device="cpu")]


def two_processes_match_one(graphs, tmp_path, variant):
    torch.save(graphs, tmp_path / "graphs.pt")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys, test_torch_distributed as t; "
         f"t.worker({r}, 2, {port}, sys.argv[1], {variant!r})",
         str(tmp_path)],
        env=child_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    states = [torch.load(tmp_path / f"state{r}.pt") for r in range(2)]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "best_model.msgpack", "final_model.msgpack", "history.json"]
    one = train_two_steps(make_mesh(n_data=2, devices=["cpu"] * 2), graphs,
                          tmp_path / "one", variant).model.state_dict()
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k
        torch.testing.assert_close(v, one[k], rtol=0, atol=PARAM_TOL)


def test_two_processes_match_one(graphs, tmp_path):
    """Two gloo processes, one data rank each, end with identical
    parameters, equal to one process holding both ranks."""
    two_processes_match_one(graphs, tmp_path, "resgcn")


def test_two_processes_match_one_gcn(graphs, tmp_path):
    """GCNTrimapNet over two gloo processes: every hidden InputNorm's
    statistics are all-reduced in the forward and their gradients in the
    backward; the parameters and running statistics equal one process
    holding both ranks."""
    two_processes_match_one(graphs, tmp_path, "gcn")


def test_init_distributed_is_a_no_op_outside_a_cluster(monkeypatch):
    import torch.distributed as dist
    for k in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    init_distributed(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    init_distributed(device="cpu")
    assert not dist.is_initialized() and process_count() == 1
    with pytest.raises(ValueError, match="num_processes"):
        init_distributed("localhost:1", device="cpu")


def test_train_cli_under_torchrun_matches_solo(tmp_path):
    """cli.train --devices 2 --cpu under torchrun trains over gloo and
    reproduces the single-process CLI's history (fp32, dropout on)."""
    args = ["--synthetic", "8", "--epochs", "2", "--hidden", "16",
            "--layers", "2", "--n-segments", "64", "--batch", "4", "--cpu",
            "--no-bf16", "--prior-dropout", "0.2"]
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "gcn_grabcut_torch.cli.train", *args,
         "--devices", "2", "--save-dir", str(tmp_path / "dp")],
        env=child_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=TIMEOUT_S, check=False)
    assert res.returncode == 0, (res.stdout + res.stderr)[-3000:]
    assert res.stdout.count("data-parallel over 2 device(s)") == 2
    ttrain.main(args + ["--save-dir", str(tmp_path / "solo")])
    dp, solo = (json.loads((tmp_path / d / "history.json").read_text())
                for d in ("dp", "solo"))
    np.testing.assert_allclose(dp["train_loss"], solo["train_loss"],
                               rtol=DP_LOSS_RTOL)
    np.testing.assert_allclose(dp["val_score"], solo["val_score"],
                               rtol=DP_SCORE_RTOL, atol=DP_SCORE_ATOL)
    assert dp["lr"] == solo["lr"]
