"""A configuration, a traffic mix, the phase it names, a metric and a
kernel list added as new files in a copy are found by name, with no file of
the harness edited."""

import json

import tiny


def test_new_files_are_found_by_name(tmp_path):
    root = tiny.make(tmp_path)
    bench = root / "portbench"
    cfg = json.loads((bench / "configs" / "mv2dl_camvid.json").read_text())
    cfg["name"] = "mv2dl_other"
    cfg["pool_batch_size"] = 3
    (bench / "configs" / "mv2dl_other.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "sweep.json").read_text())
    traffic["phase"] = "sweep_again"
    (bench / "traffic" / "sweep_again.json").write_text(json.dumps(traffic))
    (bench / "phases" / "sweep_again.py").write_text(
        (bench / "phases" / "sweep.py").read_text())
    (bench / "limits" / "mv2dl_other.sweep_again.json").write_text(
        (bench / "limits" / "mv2dl_camvid.sweep.json").read_text())
    (bench / "metrics" / "sweeps_done.sweep.py").write_text(
        "def read(ctx):\n    return float(ctx.window['sweeps'])\n")
    (bench / "kernels" / "depthwise_roofline.sweep.other.json").write_text(
        json.dumps({"impl": "another kernel", "kernels": ["other_dw"]}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "mv2dl_other", "source": "x",
                            "file": "portbench/configs/mv2dl_other.json",
                            "reduced": ["pool_batch_size"], "why": "test"})
    spec["workloads"].append({"name": "mv2dl_other.sweep_again",
                              "config": "mv2dl_other",
                              "traffic": "sweep_again", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "sweeps_done.sweep", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "acquisition",
                              "moves": "sweep_images_per_s",
                              "workloads": ["mv2dl_other.sweep_again"]})
    for m in spec["end_to_end"]:
        if m["name"] == "sweep_images_per_s":
            m["workloads"].append("mv2dl_other.sweep_again")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    import sys
    sys.path.insert(0, str(bench))
    try:
        from importlib import reload

        import pb.cell
        reload(pb.cell)
        cell = pb.cell.Cell("mv2dl_other.sweep_again", root=bench)
        assert cell.config["pool_batch_size"] == 3
        assert [m["name"] for m in cell.per_layer()] == ["sweeps_done.sweep"]
        assert "other_dw" in cell.kernel_names("depthwise_roofline.sweep")
        assert "dw3x3_s1_nhwc" in cell.kernel_names(
            "depthwise_roofline.sweep")
    finally:
        sys.path.remove(str(bench))

    res = tiny.result(tiny.run(root, "mv2dl_other.sweep_again", trace=1))
    assert res["correct"] is True
    assert res["metrics"]["sweeps_done.sweep"]["value"] >= 1
