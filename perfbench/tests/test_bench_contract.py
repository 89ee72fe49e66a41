"""``BENCHMARK.json`` against the rules it is checked by: keys, names,
units, bounds, the cells each metric names, and each configuration's file
against the source keys it copies."""

import json
import re

from conftest import ROOT

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def applies(m, cell):
    return "workloads" not in m or cell in m["workloads"]


def test_keys_names_and_units():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        extra = {"workloads"} if "workloads" in m else set()
        keys = ({"name", "unit", "better", "bound", "source"}
                if m in B["end_to_end"] else
                {"name", "unit", "better", "source", "layer", "moves"})
        assert set(m) == keys | extra, m["name"]
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(B["paths"][0] + "/")


def test_bounds():
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in B["end_to_end"])


def test_every_cell_reports_what_its_metrics_move():
    cells = {w["name"] for w in B["workloads"]}
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for m in B["per_layer"]:
        assert set(m["workloads"]) <= cells
        for c in m["workloads"]:
            assert applies(e2e[m["moves"]], c), (m["name"], c)
    for c in cells:
        assert applies(e2e["setup_s"], c)
        assert sum(applies(m, c) for m in B["end_to_end"]) >= 2
        assert any(applies(m, c) for m in B["per_layer"])


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configuration_files_run_the_keys_they_copy():
    g = json.loads((ROOT / "perfbench/configs/granite-3-8b.json").read_text())
    p = g["port"]
    assert (p["n_layers"], p["d_model"], p["n_heads"], p["n_kv_heads"],
            p["head_dim"], p["d_ff"], p["vocab"], p["rope_theta"],
            p["norm_eps"], p["tie_embeddings"]) == (
        g["num_hidden_layers"], g["hidden_size"], g["num_attention_heads"],
        g["num_key_value_heads"], g["head_dim"], g["intermediate_size"],
        g["vocab_size"], g["rope_theta"], g["rms_norm_eps"],
        g["tie_word_embeddings"])
    m = json.loads((ROOT / "perfbench/configs/mamba2-2.7b.json").read_text())
    p, s = m["port"], m["ssm_cfg"]
    pad = m["pad_vocab_size_multiple"]
    assert (p["n_layers"], p["d_model"], p["vocab"], p["norm_eps"],
            p["tie_embeddings"]) == (m["n_layer"], m["d_model"],
                                     -(-m["vocab_size"] // pad) * pad,
                                     m["norm_epsilon"], m["tie_embeddings"])
    assert (p["ssm"]["d_state"], p["ssm"]["conv_width"], p["ssm"]["expand"],
            p["ssm"]["head_dim"], p["ssm"]["chunk"]) == (
        s["d_state"], s["d_conv"], s["expand"], s["headdim"],
        s["chunk_size"])
    for cfg in (g, m):
        assert cfg["port"]["param_dtype"] == cfg["torch_dtype"]


def test_reduced_names_every_key_run_apart_from_its_source():
    for c in B["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        published = cfg.get("published", {})
        assert sorted(c["reduced"]) == sorted(published)
        for key, (value, why) in published.items():
            assert cfg[key] != value and why
