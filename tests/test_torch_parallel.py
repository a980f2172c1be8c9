"""The port's data-parallel plumbing (``gomatching_tpu_torch/parallel``): the mesh
arithmetic against JAX ``build_mesh``, the rank arithmetic and the rendezvous of each
``--dist-url`` form, ``--num-gpus 0``, the refusal of a launch larger than the visible
cards, and spawned gloo ranks (a ``file://`` rendezvous in ``tmp_path``: TCP ports would
collide across test workers): ``all_reduce_mean_``, ``gather_shapes``, ``host_group``'s
one gloo group, a rank that raises or hangs failing the launch, and ``train_net``'s
launch given no deadline (a launch without one outlasting the collective timeout is in
``test_torch_ddp.py``, which has the time for it)."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import torch_dp_workers as workers  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml")


@pytest.mark.parametrize("opts", [None, ("2", "-1"), ("4", "2"), ("-1", "8")])
def test_mesh_shape_matches_jax_build_mesh(opts):
    """(data, model) of ``mesh_shape`` equal JAX ``build_mesh``'s over the 8 virtual CPU
    devices, with no cfg and with TPU.MESH_MODEL / TPU.MESH_DATA (test_parallel.py's
    cases and two more); where JAX asserts, the port raises."""
    from gomatching_tpu.config import setup_eval_cfg as jax_cfg
    from gomatching_tpu.parallel import build_mesh
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.parallel.mesh import mesh_shape

    n = len(jax.devices())
    assert n == 8
    if opts is None:
        mesh = build_mesh()
        assert mesh_shape(None, n) == (mesh.shape["data"], mesh.shape["model"]) == (8, 1)
        return
    extra = ["MODEL.WEIGHTS", "''", "TPU.MESH_MODEL", opts[0], "TPU.MESH_DATA", opts[1]]
    jcfg, tcfg = jax_cfg(CONFIG, extra), setup_eval_cfg(CONFIG, extra)
    try:
        mesh = build_mesh(jcfg)
    except AssertionError:
        with pytest.raises(ValueError, match="devices"):
            mesh_shape(tcfg, n)
        return
    assert mesh_shape(tcfg, n) == (mesh.shape["data"], mesh.shape["model"])


def test_dist_url_forms_and_num_gpus(monkeypatch):
    """Each ``--dist-url`` form gives its init_method: tcp:// as it is, host:port as
    tcp://, file:// as it is, auto as env:// across machines or with MASTER_ADDR set and a
    free local port on one machine without it; anything else raises. ``--num-gpus 0`` is
    every visible card, refused with ``--cpu`` and without a card."""
    from gomatching_tpu_torch.parallel.launch import init_method_of, resolve_num_gpus

    assert init_method_of("tcp://10.0.0.1:1234") == "tcp://10.0.0.1:1234"
    assert init_method_of("10.0.0.1:1234", 2) == "tcp://10.0.0.1:1234"
    assert init_method_of("file:///tmp/x") == "file:///tmp/x"
    assert init_method_of("auto", 2) == "env://"
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    local = init_method_of("auto", 1)
    assert local.startswith("tcp://127.0.0.1:") and int(local.rsplit(":", 1)[1]) > 0
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    assert init_method_of("auto", 1) == "env://"
    with pytest.raises(ValueError, match="dist-url"):
        init_method_of("somewhere")
    assert resolve_num_gpus(3, cpu=True) == 3
    with pytest.raises(ValueError, match="--cpu"):
        resolve_num_gpus(0, cpu=True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_num_gpus(0, cpu=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert resolve_num_gpus(0, cpu=False) == 4


def test_train_net_num_gpus_zero_with_cpu_is_refused(tmp_path):
    from gomatching_tpu_torch import train_net

    with pytest.raises(ValueError, match="--cpu"):
        train_net.main(["--config-file", CONFIG, "--cpu", "--num-gpus", "0", "--opts",
                        "MODEL.WEIGHTS", "''", "OUTPUT_DIR", str(tmp_path / "out")])


def test_launch_larger_than_the_visible_cards_is_refused():
    from gomatching_tpu_torch.parallel.launch import launch

    n = torch.cuda.device_count() + 2
    with pytest.raises(ValueError, match="more cards than"):
        launch(workers.collectives, n, args=([0.0] * n,))
    with pytest.raises(ValueError, match="NCCL cannot put two ranks"):
        launch(workers.collectives, 2, backend="nccl", device="cuda:0", args=([0.0] * 2,))


def test_two_machines_of_two_ranks_reduce_and_gather(tmp_path):
    """Two launches, machine ranks 0 and 1 of 2, two CPU processes each: global rank =
    machine_rank x num_gpus + local rank of a world of 4; ``all_reduce_mean_`` averages
    both tensors through one buffer (the same bits on every rank), ``gather_shapes``
    returns every rank's shape in rank order, and only global rank 0 is main."""
    from concurrent.futures import ThreadPoolExecutor

    from gomatching_tpu_torch.parallel.launch import launch

    values = [1.0, 2.5, -4.0, 8.25]
    url = f"file://{tmp_path / 'rendezvous'}"
    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(launch, workers.collectives, 2, 2, m, url, (values,),
                               device="cpu", timeout_s=240) for m in (0, 1)]
        out = [r for f in futures for r in f.result()]
    assert [r["rank"] for r in out] == [0, 1, 2, 3] and {r["world"] for r in out} == {4}
    mean = float(np.mean(values))
    for r in out:
        assert r["mean"] == [[mean] * 3, [[10 * mean] * 2] * 2]
        assert r["shapes"] == [(k, 5 + k, 7) for k in range(4)]
    assert [r["main"] for r in out] == [True, False, False, False]
    assert all(r["host_group"] == (True, "gloo", [0, 1, 2, 3]) for r in out)


def test_a_rank_that_raises_fails_the_launch(tmp_path):
    """Rank 1 raises while rank 0 waits for it in a collective: the launch raises with
    rank 1's error and stops rank 0."""
    from gomatching_tpu_torch.parallel.launch import launch

    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        launch(workers.raise_on_rank1, 2, dist_url=f"file://{tmp_path / 'r'}", device="cpu",
               timeout_s=240)


def test_train_net_launches_without_a_deadline(tmp_path, monkeypatch):
    """``train_net.main`` over 2 ranks launches with no ``timeout_s``, and ``launch``'s
    own default is no deadline: a real run lasts far longer than any fixed limit."""
    import inspect

    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.parallel import launch as launch_mod

    assert inspect.signature(launch_mod.launch).parameters["timeout_s"].default is None
    calls = []

    def record(main_fn, num_gpus, *args, **kwargs):
        calls.append((num_gpus, args, kwargs))
        return [["history of local rank 0"], ["history of local rank 1"]]

    monkeypatch.setattr(launch_mod, "launch", record)
    out = train_net.main(["--config-file", CONFIG, "--cpu", "--num-gpus", "2", "--opts",
                          "MODEL.WEIGHTS", "''", "OUTPUT_DIR", str(tmp_path / "out")])
    assert out == ["history of local rank 0"]
    assert len(calls) == 1 and calls[0][0] == 2 and "timeout_s" not in calls[0][2]


def test_a_rank_that_hangs_fails_the_launch(tmp_path):
    """Rank 1 never returns: the launch raises at its time limit and kills it."""
    from gomatching_tpu_torch.parallel.launch import launch

    with pytest.raises(TimeoutError, match="outlived"):
        launch(workers.hang_on_rank1, 2, dist_url=f"file://{tmp_path / 'h'}", device="cpu",
               timeout_s=15)
