"""A cell, a configuration, a traffic mix and a metric added as new files
only are found by the names BENCHMARK.json gives."""

import json
import os
import shutil
from types import SimpleNamespace

from helpers_vrbench import ROOT

from vrbench.cell import load_cell, reader


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(os.path.join(ROOT, "vrbench"), tmp_path / "vrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    v = tmp_path / "vrbench"
    (v / "configs" / "cloud512_dim.json").write_text(json.dumps({"name": "cloud512_dim",
                                                                 "settings": {"bounces": 7}}))
    (v / "traffic" / "burst.json").write_text(json.dumps({"spp": 16}))
    (v / "metrics" / "steps_run.py").write_text("def read(ctx):\n    return len(ctx.records)\n")
    bench["configs"].append({"name": "cloud512_dim", "source": "x",
                             "file": "vrbench/configs/cloud512_dim.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "cloud512_dim.burst", "config": "cloud512_dim",
                               "traffic": "burst", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps_run", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "renderer",
                               "moves": "setup_s", "workloads": ["cloud512_dim.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell("cloud512_dim.burst", root=str(tmp_path))
    assert cell.config["settings"]["bounces"] == 7 and cell.traffic["spp"] == 16
    # the new cell reports setup_s alone: no keyless per-layer metric moves it
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["steps_run"]
    assert reader("steps_run", root=str(tmp_path))(SimpleNamespace(records=[1, 2, 3])) == 3
    old = load_cell("cloud512.offline", root=str(tmp_path))
    assert [m["name"] for m in old.end_to_end] == ["spp_s", "setup_s"]
    assert [m["name"] for m in old.per_layer] == ["megakernel_roofline", "device_idle_pct"]
    step = load_cell("cloud512_fire.interactive", root=str(tmp_path))
    assert [m["name"] for m in step.end_to_end] == ["step_ms_p95", "setup_s"]
    assert [m["name"] for m in step.per_layer] == ["megakernel_roofline.step",
                                                   "device_idle_pct.step", "trace_host_ms"]
    assert reader("megakernel_roofline.step", root=str(tmp_path))(
        SimpleNamespace(device="cpu")) is None
