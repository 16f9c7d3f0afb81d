"""The run's rules: the import rule in a fresh interpreter, the last
line's keys, the checks printed last, a lower-precision program refused,
and each planted fault refused."""

import json
import subprocess
import sys

import pytest

import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "pixelpick_tpu"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


def loaded_after(code: str, cwd) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json; print(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=cwd, capture_output=True, text=True, check=True,
        env={"PYTHONPATH": str(tiny.REPO), "PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_load_no_jax(root):
    harness = loaded_after(
        "import sys; sys.path.insert(0, 'portbench'); import run, "
        "calibrate; from pb import cell, check, counts, data, phase, "
        "readers, trace, weights; import pixelpick_tpu_torch.active.driver",
        root)
    assert not harness & FORBIDDEN
    ref = loaded_after("import sys; sys.path.insert(0, 'portbench'); "
                       "from reference import augment, nets, steps", root)
    assert not ref & (FORBIDDEN | {"pixelpick_tpu_torch"})


def test_a_run_prints_the_result_last(root):
    proc = tiny.run(root, "mv2dl_camvid.val", trace=0)
    res = tiny.result(proc)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True
    assert set(res["metrics"]) == {"val_images_per_s", "val_image_ms_p95",
                                   "setup_s"}
    tail = proc.stderr.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[1] for line in tail] == list(res["checks"])


def test_a_traced_run_reports_its_per_layer_metrics(root):
    res = tiny.result(tiny.run(root, "mv2dl_camvid.sweep", trace=1))
    assert res["correct"] is True
    # the CPU has no peaks and no device: mfu, roofline, idle stay silent
    assert set(res["metrics"]) == {"loader_wait_ms.sweep",
                                   "score_host_ms.sweep"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(root):
    code = ("import sys; sys.path.insert(0, 'portbench'); import run; "
            "sys.exit(run.main(['--workload', 'mv2dl_camvid.val', '--seed', "
            "'1', '--seconds', '1']))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True,
                          env={"PYTHONPATH": str(tiny.REPO),
                               "PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_sound_training_run_is_correct(root):
    res = tiny.result(tiny.run(root, "r50fpn_voc.train"))
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"train_images_per_s", "setup_s"}


def test_a_camvid_training_run_profiles_after_its_window(root):
    """Its end-to-end card time per image is read from a profiled stretch
    after the window in a --trace 0 run too; the CPU has no device, so the
    metric stays silent, and the untraced line keeps no trace keys."""
    res = tiny.result(tiny.run(root, "mv2dl_camvid.train", trace=0))
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"setup_s"}
    assert not {"busy_s", "window_s"} & set(res["device"])
    assert "breakdown" not in res


def test_no_port_no_result(tmp_path):
    """A directory with only ``BENCHMARK.json`` and the benchmark's files."""
    import shutil

    shutil.copytree(tiny.BENCH, tmp_path / "portbench")
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, 'portbench'); import run; "
            "sys.exit(run.main(['--workload', 'mv2dl_camvid.val', '--seed', "
            "'1', '--seconds', '1'], device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("workload", ["r50fpn_voc.train", "mv2dl_camvid.val",
                                      "mv2dl_camvid.sweep"])
def test_a_lower_precision_program_is_refused(tmp_path, workload):
    """The port's own bf16 path in place of the f32 it is configured
    for."""
    low = tiny.make(tmp_path, precision="bf16")
    res = tiny.result(tiny.run(low, workload))
    assert res["correct"] is False


@pytest.mark.parametrize("workload,fault", [
    ("r50fpn_voc.train", "unchanged"),
    ("r50fpn_voc.train", "half_batch"),
    ("r50fpn_voc.train", "mislabelled"),
    ("mv2dl_camvid.val", "altered"),
    ("mv2dl_camvid.sweep", "altered")])
def test_a_planted_fault_is_refused(root, workload, fault):
    res = tiny.result(tiny.run(root, workload, fault=fault))
    assert res["correct"] is False


def test_a_forbidden_module_loaded_late_gives_no_result(tmp_path):
    """A metric reader, which runs after the window, that loads a module
    named ``jax``: the run prints no result."""
    root = tiny.make(tmp_path)
    reader = root / "portbench" / "metrics" / "val_images_per_s.py"
    reader.write_text(reader.read_text() + (
        "\n\nimport sys as _sys\nimport types as _types\n"
        "_sys.modules['jax'] = _types.ModuleType('jax')\n"))
    proc = tiny.run(root, "mv2dl_camvid.val")
    assert proc.returncode != 0
    assert proc.stdout.strip() == "" or not proc.stdout.strip().splitlines(
    )[-1].startswith("{")
    assert "jax" in proc.stderr.strip().splitlines()[-1]


@pytest.mark.parametrize("where", ["config", "traffic"])
@pytest.mark.parametrize("flag", ["device_augment", "micro_batch_size",
                                  "use_mc_dropout", "precision"])
def test_a_flag_the_phase_does_not_drive_is_refused(where, flag):
    """A port flag in a configuration's or traffic mix's ``port_args`` that
    the phase's loop does not honour, or that the configuration states at
    its top level, stops the run before the port is built."""
    from pb.phase import MODEL_FLAGS, port_overrides
    from tests_paths import CONFIGS

    cfg = json.loads((CONFIGS / "mv2dl_camvid.json").read_text())
    traffic = {"phase": "train"}
    (cfg if where == "config" else traffic).setdefault(
        "port_args", {})[flag] = True
    with pytest.raises(ValueError, match=flag):
        port_overrides(cfg, traffic, MODEL_FLAGS)
