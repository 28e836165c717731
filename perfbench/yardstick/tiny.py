"""Tiny cells for the CPU tests: a benchmark root in a temporary
directory whose ``BENCHMARK.json`` lists an ``added`` path of new files
(configurations, a mix and limits at test sizes) before this benchmark's
own folder, so the harness finds each by name as it would a later
change's added files.
"""
from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

#: test sizes of the two layer kinds (every width divides the data axis)
SIZES = {
    "A": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=128, vocab_size=500, attn_block_q=32,
              attn_block_kv=64),
    "L": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
              head_dim=16, d_ff=128, vocab_size=500, q_lora_rank=32,
              kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
              v_head_dim=16, attn_block_q=32, attn_block_kv=64),
}
SOURCES = {"A": "mistral-7b", "L": "minicpm3-4b"}


def _dump(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def config(kind: str, dtype: str = "float32") -> dict:
    conf = json.loads((HERE / "configs" / f"{SOURCES[kind]}.json")
                      .read_text())
    conf["model"].update(SIZES[kind], dtype=dtype)
    return conf


def root(tmp: Path, dtype: str = "float32", limits: dict | None = None,
         seq: int = 64) -> Path:
    """A benchmark root with cells "tiny-a.train", "tiny-l.train" and
    "tiny-a.recover"; ``limits`` (default: this benchmark's
    mistral-7b train limits) for the train cells."""
    tmp = Path(tmp)
    (tmp / "perfbench").symlink_to(HERE, target_is_directory=True)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    bench["paths"] = ["added", "perfbench"]
    bench["configs"] = []
    for kind, name in (("A", "tiny-a"), ("L", "tiny-l")):
        _dump(tmp / "added" / "configs" / f"{name}.json", config(kind, dtype))
        bench["configs"].append(dict(
            name=name, source="test", file=f"added/configs/{name}.json",
            reduced=[], why="test"))
    mix = json.loads((HERE / "mixes" / "train-ec.json").read_text())
    mix.update(seq=seq, pool=6, trace_steps=1)
    _dump(tmp / "added" / "mixes" / "train-tiny.json", mix)
    bench["workloads"] = [
        dict(name="tiny-a.train", config="tiny-a", traffic="train-tiny",
             chips=1, why="test"),
        dict(name="tiny-l.train", config="tiny-l", traffic="train-tiny",
             chips=1, why="test"),
        dict(name="tiny-a.recover", config="tiny-a", traffic="recover",
             chips=1, why="test")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    _dump(tmp / "BENCHMARK.json", bench)
    if limits is None:
        limits = json.loads((HERE / "limits" / "mistral-7b.train-ec.json")
                            .read_text())
    for w in ("tiny-a.train", "tiny-l.train"):
        _dump(tmp / "added" / "limits" / f"{w}.json", limits)
    _dump(tmp / "added" / "limits" / "tiny-a.recover.json",
          json.loads((HERE / "limits" / "mistral-7b.recover.json")
                     .read_text()))
    return tmp
