"""The PyTorch port stands alone: it imports no JAX and nothing of gomatching_tpu,
and its entry points never fall back to the CPU silently."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gomatching_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_importing_the_port_pulls_in_no_jax():
    mods = _port_modules()
    for m in ("engine.predictor", "engine.pretrain", "engine.spotter_losses", "engine.optim",
              "engine.checkpoint", "data.bezier", "data.datasets", "data.image_augment",
              "train_net", "ops.deform_attn_merged", "ops.deform_attn_vmem",
              "ops.deform_attn_fused", "tools.bench_deform_attn", "ops.gather_probe",
              "ops.onehot_g", "tools.bench_gather", "tools.probe_bf16_g", "models.swin",
              "models.vitae", "utils.synthetic", "parallel", "parallel.mesh",
              "parallel.launch", "parallel.dryrun", "tools.bovtext_sample_recovery"):
        assert f"gomatching_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'gomatching_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_port_file_names_the_jax_package():
    pattern = re.compile(r"import jax|gomatching_tpu\b[.]|from jax|import flax")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith((".py", ".cu"))]
    offenders = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if pattern.search(line):
                    offenders.append(f"{os.path.relpath(path, ROOT)}:{i}: {line.strip()}")
    assert not offenders, offenders


def test_entry_points_raise_without_cuda():
    import torch

    from gomatching_tpu_torch import resolve_device
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU behaviour")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    cfg = setup_eval_cfg(os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml"),
                         ["MODEL.WEIGHTS", "''"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VideoPredictor(cfg)
    assert resolve_device("cpu").type == "cpu"


def test_eval_cli_refuses_gpu_run_without_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU behaviour")
    (tmp_path / "videos").mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "gomatching_tpu_torch.eval", "--config-file",
         "configs/GoMatching_ICDAR15.yaml", "--input", str(tmp_path / "videos"),
         "--output", str(tmp_path / "out"), "--opts", "MODEL.WEIGHTS", "''"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "CUDA" in proc.stderr, proc.stderr[-2000:]


def test_train_cli_refuses_gpu_run_without_cuda():
    import torch

    from gomatching_tpu_torch import train_net

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU behaviour")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_net.main(["--config-file", os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml"),
                        "--task", "spotter", "--opts", "MODEL.TRANSFORMER.ENC_LAYERS", "1",
                        "MODEL.TRANSFORMER.DEC_LAYERS", "1"])


def test_tracker_train_cli_refuses_gpu_run_without_cuda():
    import torch

    from gomatching_tpu_torch import train_net

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU behaviour")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_net.main(["--config-file", os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml"),
                        "--task", "tracker", "--opts", "MODEL.WEIGHTS", "''",
                        "MODEL.TRANSFORMER.ENC_LAYERS", "1", "MODEL.TRANSFORMER.DEC_LAYERS", "1",
                        "OUTPUT_DIR", os.path.join(os.environ.get("TMPDIR", "/tmp"),
                                                   "port_tracker_no_cuda")])


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    """A wrapper runs the plain version only for CPU tensors; anything else launches
    the kernel or raises (here: the meta device)."""
    import torch

    from gomatching_tpu_torch.ops import deform_attn as da
    from gomatching_tpu_torch.ops import deform_attn_fused as daf
    from gomatching_tpu_torch.ops import deform_attn_merged as dam
    from gomatching_tpu_torch.ops import deform_attn_vmem as dav
    from gomatching_tpu_torch.ops import gather_probe as gp
    from gomatching_tpu_torch.ops import onehot_g as og

    value = torch.empty(1, 4, 2, 8, device="meta")
    loc = torch.empty(1, 3, 2, 1, 2, 2, device="meta")
    attn = torch.empty(1, 3, 2, 1, 2, device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        da.ms_deform_attn_queries(value, [(2, 2)], loc, attn)
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        da.ms_deform_attn_encoder(value, [(2, 2)], torch.empty(1, 4, 2, 1, 2, 2, device="meta"),
                                  torch.empty(1, 4, 2, 2, device="meta"))
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        dam.ms_deform_attn_merged(value, [(2, 2)], loc, attn)
    enc_loc = torch.empty(1, 4, 2, 1, 2, 2, device="meta")
    enc_attn = torch.empty(1, 4, 2, 1, 2, device="meta")
    for entry in (dav.ms_deform_attn_encoder_vmem, daf.ms_deform_attn_encoder_fused):
        with pytest.raises(ValueError, match="CPU or on one CUDA"):
            entry(value, [(2, 2)], enc_loc, enc_attn)
    with pytest.raises(ValueError, match="CPU or on one CUDA"):  # 128 tile-major slots
        dav.ms_deform_attn_encoder_vmem_tm(value, [(2, 2)],
                                           torch.empty(1, 2, 1, 2, 2, 128, device="meta"),
                                           torch.empty(1, 2, 1, 2, 128, device="meta"))
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        dav.ms_deform_attn_encoder_vmem_v3(value, [(2, 2)], torch.empty(1, 8, 128, device="meta"),
                                           torch.empty(1, 4, 128, device="meta"))
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        da.ms_deform_attn_queries_backward(value, [(2, 2)], loc, attn,
                                           torch.empty(1, 3, 16, device="meta"))
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        da.ms_deform_attn_encoder_backward(value, [(2, 2)],
                                           torch.empty(1, 4, 2, 1, 2, 2, device="meta"),
                                           torch.empty(1, 4, 2, 2, device="meta"),
                                           torch.empty(1, 4, 16, device="meta"))
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        gp.gather_rows_sum(torch.empty(4, 32, device="meta"),
                           torch.empty(2, 4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        og.onehot_g(*(torch.empty(2, 8, device="meta") for _ in range(3)), 4, 4)
