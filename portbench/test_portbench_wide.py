"""The ``rmat17-u18-wide`` cell's pieces on the CPU: its frozen stages are
the program's plan for its template; its two per-layer readers read what
they should from a trace (kernel A's wide route, with the heavy kernels
each launch issues before it) and from the program's spans, and nothing
from a program that records no range spans; its reference, the tree DP
with the root walked by blocks of vertices, counts what the plain one
counts, and its driver leaves the plain one in place."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.common import Context
from portbench.registry import Benchmark
from portbench.roofline import bound_s, fused_stage_work
from portbench.shapes import shape_of, tree_stages
from portbench.trace import DeviceEvent, TraceSummary

ROOT = Path(__file__).resolve().parents[1]
BENCH = Benchmark(ROOT)
CFG = BENCH.config("rmat17-u18")


def ev(name, ms, t0):
    return DeviceEvent(name, t0, t0 + int(ms * 1e6))


def summary(events, busy_s=1.0):
    return TraceSummary(window_s=2.0, busy_s=busy_s, device_events=events, seconds_by_name={})


def test_frozen_stages_are_the_programs_plan():
    from repro_torch.core.templates import Template
    from repro_torch.plan.ir import build_template_plan

    edges = [tuple(e) for e in CFG["templates"]["u18"]]
    ir = build_template_plan([Template("u18", edges)])
    cplan, canons = ir.counting_plans[0], ir.canons[0]
    stages, seen = [], set()
    for i, sub in enumerate(cplan.partition.subs):
        if not sub.is_leaf and canons[i] not in seen:
            seen.add(canons[i])
            stages.append([canons[i], sub.size, cplan.partition.subs[sub.active].size])
    assert stages == CFG["shapes"]["u18"]["tree"]
    wide = [(st.m, st.m_a) for st in tree_stages([shape_of(CFG, "u18")]) if st.c_p + st.c_a > 28_672]
    assert wide == [(10, 7), (14, 10)]


def test_traffic_and_check():
    cell = BENCH.cell("rmat17-u18-wide")
    traffic, check = BENCH.traffic(cell["traffic"]), BENCH.check("rmat17-u18-wide")
    assert traffic["kind"] == "estimates-rootblocks" and traffic["templates"] == ["u18"]
    assert traffic["colorings"] == 16 and traffic.get("entry", "count_keys") == "count_keys"
    assert check["sample"] >= 1 and 0 < check["max_rel_gap_limit"] < 1e-2
    assert CFG["graph"]["edges"] == CFG["graph"]["edgefactor"] * CFG["graph"]["n"] == 16 << 17


@pytest.mark.parametrize("heavy", [False, True])
def test_wide_roofline_reads_the_wide_route(heavy):
    read = BENCH.reader("kernel_a_wide_roofline.wide")
    pre = [ev("edge_walk::heavy_segments_kernel<4>", 1.0, 0),
           ev("edge_walk::heavy_reduce_kernel", 1.0, 0)] if heavy else []
    events = (pre + [ev("spmm_ema_kernel<4,1,32>", 5.0, 0)]  # a narrow stage, not counted
              + pre + [ev("wide_aggregate_kernel<4,1,32>", 10.0, 0), ev("wide_ema_kernel", 30.0, 0),
                       ev("wide_aggregate_kernel<4,1,32>", 10.0, 0), ev("wide_ema_kernel", 30.0, 0)]
              + [ev("at::native::elementwise_kernel", 7.0, 0)])
    shape = shape_of(CFG, "u18")
    ctx = Context(n=1 << 17, e=3_727_900, templates=[shape], chunk_size=1, chunks=3,
                  trace=summary(events))
    seconds = (80.0 + (2.0 if heavy else 0.0)) / 1e3
    least = sum(bound_s(*fused_stage_work(st, ctx.n, ctx.e, 1))[0]
                for st in tree_stages([shape]) if st.c_p + st.c_a > 28_672)
    assert read(ctx) == pytest.approx(100.0 * 3 * least / seconds)
    assert read(Context(n=1, e=1, templates=[shape], chunks=3)) is None  # no trace
    narrow = Context(n=1, e=1, templates=[shape], chunk_size=1, chunks=3,
                     trace=summary(events[:len(pre) + 1]))
    assert read(narrow) is None


def test_range_share_reads_device_timed_spans(monkeypatch):
    from repro_torch import obs

    read = BENCH.reader("range_share.wide")
    ctx = Context(n=1, e=1, templates=[], trace=summary([], busy_s=2.0))
    monkeypatch.setattr(obs, "spans", lambda name=None: [])
    assert read(ctx) is None  # a program without the spans: nothing, no error
    spans = [SimpleNamespace(device_ms=m) for m in (1.0, 3.0, None)]
    monkeypatch.setattr(obs, "spans", lambda name=None: spans if name == "repro_torch.engine.range"
                        else [])
    assert read(ctx) == pytest.approx(100.0 * 4e-3 / 2.0)
    assert read(Context(n=1, e=1, templates=[])) is None


def test_entries_name_the_new_cell_only_where_asked():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in ("kernel_a_wide_roofline.wide", "range_share.wide"):
        assert per_layer[name]["workloads"] == ["rmat17-u18-wide"]
    assert [m["name"] for m in BENCH.per_layer("rmat17-u18-wide")] == [
        "kernel_a_wide_roofline.wide", "range_share.wide"]
    assert {m["name"] for m in BENCH.end_to_end("rmat17-u18-wide")} == {"setup_s",
                                                                        "colorings_per_s"}


@pytest.mark.parametrize("edges", [
    ((0, 1), (1, 2), (2, 3), (3, 4)),
    ((0, 1), (1, 2), (0, 3), (3, 4), (0, 5), (5, 6), (6, 7)),  # three children at the root
    ((0, 1), (0, 2), (1, 3), (1, 4), (2, 5), (2, 6), (3, 7), (4, 8), (5, 9), (6, 10), (10, 11)),
], ids=["path5", "spider8", "u12"])
def test_rootblocks_reference_counts_as_the_plain_one(monkeypatch, edges):
    import math

    import torch

    from portbench.reference import colorcoding, rootblocks, threefry
    from portbench.reference.rmat import rmat_edges

    k, n = colorcoding.num_vertices(edges), 40
    src, dst = rmat_edges(n, 6 * n, 3, 0.57, 0.19, 0.19, device=torch.device("cpu"))
    adj = colorcoding.Adjacency(src, dst, n, dense=False)
    # blocks of a few rows, so the root's merges run over several
    monkeypatch.setattr(rootblocks, "ROOT_BLOCK_BYTES", 8 * 7 * math.comb(k, k // 2))
    for seed in range(3):
        colors = threefry.randint(threefry.prng_key(seed), n, k)
        want = colorcoding.tree_colorful_count(adj, colors, edges)
        assert want > 0 and rootblocks.tree_colorful_count(adj, colors, edges) == want


def test_rootblocks_driver_swaps_the_tree_count_back():
    from portbench.reference import colorcoding

    plain = colorcoding.tree_colorful_count
    driver = BENCH.driver("estimates-rootblocks")
    with pytest.raises(AttributeError):
        driver(SimpleNamespace())  # fails inside the estimates driver
    assert colorcoding.tree_colorful_count is plain
