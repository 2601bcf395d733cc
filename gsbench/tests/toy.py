"""Toy sizes of the benchmark's cells, for runs on the CPU, and a root
that holds a parked cell."""
import json
import time
from pathlib import Path

from gsbench import harness

PARKED = ("view-uav-whu",)

TRAIN_CONFIG = dict(n_ground=2000, n_structs=4, per_struct=40, gaussians=2160, width=48, height=36,
                    focal_px=32.0, views=6, flight=dict(cols=3, rows=2, margin=0.6, altitude=6.5, oblique_deg=30.0),
                    densify_from_iter=4, densification_interval=4)
TRAIN_TRAFFIC = dict(warmup_iters=5, settle_iters=2, profile_after=1, profile_iters=2)
VIEW_CONFIG = dict(n_ground=2000, n_structs=4, per_struct=40)
VIEW_TRAFFIC = dict(width=64, height=36, focal_px=42.0,
                    path=dict(kind="orbit", poses=12, radius=9.0, altitude=6.5, pitch_lo=30.0, pitch_hi=45.0),
                    max_instances=65536, warmup_frames=2, check_frames=3, check_within=6, profile_frames=2)


def parked_pkg(root: Path, name: str) -> Path:
    """A benchmark root `root` whose BENCHMARK.json holds the parked cell
    `name` (gsbench/parked/<name>.json) beside the others; its gsbench/ is
    a link to the package. Returns that gsbench/."""
    bench = harness.load_benchmark()
    parked = harness.load_json(harness.PKG / "parked" / f"{name}.json")
    for key in ("workloads", "end_to_end", "per_layer"):
        bench[key] += parked[key]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "gsbench").symlink_to(harness.PKG)
    return root / "gsbench"


def run_toy(workload, seed=12345678901, seconds=1.0, **kw):
    from gsbench import run

    config, traffic = (TRAIN_CONFIG, TRAIN_TRAFFIC) if workload.startswith("train") else (VIEW_CONFIG, VIEW_TRAFFIC)
    return run.run_cell(workload, seed, seconds, False, "cpu", config=dict(config), traffic=dict(traffic),
                        t_process=time.perf_counter(), **kw)
