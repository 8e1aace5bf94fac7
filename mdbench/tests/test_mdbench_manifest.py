"""BENCHMARK.json keeps the benchmark's contract, and every file it names
exists."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT_MAX = 200
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def _text(s):
    return isinstance(s, str) and 0 < len(s) <= TEXT_MAX and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32 and all(map(_text, BENCH["command"]))


def test_names_units_and_keys():
    names = {"configs": set(), "workloads": set(), "metrics": set()}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["source"]) and _text(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names["configs"].add(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names["configs"] and w["chips"] in (1, 4)
        assert _text(w["why"])
        names["workloads"].add(w["name"])
    assert len(names["workloads"]) == len(BENCH["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for kind, extra in (("end_to_end", {"bound"}),
                        ("per_layer", {"layer", "moves"})):
        for m in BENCH[kind]:
            assert set(m) <= METRIC_KEYS | extra
            assert set(m) >= METRIC_KEYS - {"workloads"} | extra
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["name"] not in names["metrics"]
            names["metrics"].add(m["name"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == names["configs"]


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 0.01 <= e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_what_it_must():
    e2e = BENCH["end_to_end"]
    cells = [w["name"] for w in BENCH["workloads"]]
    for cell in cells:
        mine = [m["name"] for m in e2e if cell in m.get("workloads", [cell])]
        assert "setup_s" in mine and len(mine) >= 2, cell
        layer = [m for m in BENCH["per_layer"]
                 if cell in m.get("workloads", [])]
        assert layer, cell
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(m["layer"])
        moved = next(e for e in e2e if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", cells), (m["name"], cell)


def test_roofline_and_mfu_names():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["better"] == "higher"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"
    kernels = [m for m in BENCH["per_layer"]
               if m["name"].endswith("_roofline")]
    for k in kernels:
        assert any("mfu" in m["name"] and m["moves"] == k["moves"]
                   for m in BENCH["per_layer"]), k["name"]


def _with_dormant():
    """BENCHMARK.json with the cells of mdbench/dormant/ put back."""
    bench = json.loads(json.dumps(BENCH))
    for path in sorted((ROOT / "mdbench" / "dormant").glob("*.json")):
        for key, entries in json.loads(path.read_text()).items():
            bench[key] += entries
    return bench


ALL = _with_dormant()


def test_dormant_cells_are_whole_and_out_of_the_manifest():
    dormant = {w["name"] for w in ALL["workloads"]} - {
        w["name"] for w in BENCH["workloads"]}
    assert dormant
    for kind in ("end_to_end", "per_layer"):
        for m in ALL[kind]:
            if dormant & set(m.get("workloads", [])):
                assert set(m["workloads"]) <= dormant, m["name"]
                assert m["name"] not in {x["name"] for x in BENCH[kind]}


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_every_file_a_cell_names_exists(cell):
    w = next(x for x in ALL["workloads"] if x["name"] == cell)
    conf = next(c for c in ALL["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert conf["file"].startswith(tuple(p + "/" for p in ALL["paths"]))
    assert isinstance(cfg["config"], dict) and "assumed" in cfg
    traffic = json.loads((ROOT / "mdbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    assert (ROOT / "mdbench" / "loops" / f"{traffic['loop']}.py").is_file()
    limits = json.loads((ROOT / "mdbench" / "limits"
                         / f"{cell}.json").read_text())["limits"]
    assert limits and all(v > 0 for v in limits.values())
    for kind in ("end_to_end", "per_layer"):
        for m in ALL[kind]:
            if m["name"] != "setup_s":
                assert (ROOT / "mdbench" / "metrics"
                        / f"{m['name']}.py").is_file(), m["name"]


def test_config_files_are_distinct_and_complete():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    from movedepth_tpu_torch.config import Config
    for f in files:
        cfg = json.loads((ROOT / f).read_text())
        Config.from_json(json.dumps(cfg["config"]))  # every key is a field
