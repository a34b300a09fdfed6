"""The mesh backend's host side against the reference, on the CPU, with no
process group: the comm model (``CommSchedule``, ``comm_schedule``,
``mesh_comm_schedules``, ``predict_mesh_config_us``, the lattice's mesh
axis), the ``REPRO_MESH_COMM`` and link-rate overrides, ``shard_graph``'s
layouts and the streamed split tables, each equal to the reference's on the
same inputs.  Mirrors ``tests/test_comm_model.py``; the multi-rank cases
are ``tests/test_torch_mesh.py``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_counting_plan as ref_build_plan
from repro.core import get_template as ref_template
from repro.core import rmat_graph as ref_rmat
from repro.core.distributed import build_streamed_tables as ref_streamed_tables
from repro.core.distributed import shard_graph as ref_shard_graph
from repro.exec import select as ref_select
from repro.plan import cost as ref_cost
from repro.plan.ir import build_template_plan as ref_build_template_plan
from repro.tune.config import TuningConfig as RefTuningConfig

from repro_torch.core.counting import build_counting_plan
from repro_torch.core.distributed import _run_slots, build_streamed_tables, shard_graph
from repro_torch.core.graph import rmat_graph
from repro_torch.core.templates import get_template
from repro_torch.exec import select
from repro_torch.plan import cost
from repro_torch.plan.ir import build_template_plan
from repro_torch.tune.config import TuningConfig

TEMPLATES = ("u5-1", "u6", "u7", "u10", "u12")


def _models(names, n=2048, e=20_000, seed=1):
    ref = ref_cost.CostModel(
        ref_build_template_plan([ref_template(t) for t in names]), ref_rmat(n, e, seed=seed),
        jnp.float32, fusion_slack=1.0,
    )
    port = cost.CostModel(build_template_plan([get_template(t) for t in names]),
                          rmat_graph(n, e, seed=seed), torch.float32)
    return ref, port


@pytest.fixture(scope="module")
def u7():
    return _models(["u7"])


@pytest.fixture(autouse=True)
def _no_overrides(monkeypatch):
    monkeypatch.delenv(cost.MESH_LINK_ENV_VAR, raising=False)
    monkeypatch.delenv(select.MESH_COMM_ENV_VAR, raising=False)


# -- the plan-time comm model --------------------------------------------------


@pytest.mark.parametrize("names", [["u5-1"], ["u7"], ["u12"], ["path6", "star6", "u6"]])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("forced", [None, "blocking", "pipelined"])
def test_comm_schedules_equal_reference(names, n_shards, forced):
    ref, port = _models(names)
    for cb in (16, port.pick_mesh_column_batch()):
        want = ref.mesh_comm_schedules(n_shards, column_batch=cb, forced=forced)
        got = port.mesh_comm_schedules(n_shards, column_batch=cb, forced=forced)
        assert list(got) == list(want) == port.tree_group_leaders()
        for leader in want:
            assert got[leader] == cost.CommSchedule(**vars(want[leader]))
            assert got[leader].describe() == want[leader].describe()


def test_comm_schedule_with_shard_geometry_and_link_equal_reference(u7):
    ref, port = u7
    for leader in port.tree_group_leaders():
        for link in (1e-9, 50.0, 1e12):
            kw = dict(column_batch=16, rows_per_shard=700, edges_per_shard=9000,
                      link_bytes_per_us=link)
            assert port.comm_schedule(leader, 4, **kw).describe() == ref.comm_schedule(
                leader, 4, **kw).describe()


def test_single_shard_is_always_blocking(u7):
    for s in u7[1].mesh_comm_schedules(1, column_batch=16).values():
        assert s.mode == "blocking" and s.ring_steps == 1
        assert "single shard" in s.reason


def test_decision_rule_pipeline_iff_hidden_beats_ring_overhead(u7):
    _, port = u7
    for s in port.mesh_comm_schedules(4, column_batch=16, link_bytes_per_us=1e12).values():
        assert s.mode == "blocking" and "ring overhead" in s.reason
    for leader in port.tree_group_leaders():
        base = port.comm_schedule(leader, 4, column_batch=16)
        padded = base.wire_bytes // (3 * base.slice_rows * port.itemsize)
        ring_tax = max(1, padded // 16) * 4 * cost.RING_STEP_OVERHEAD_US
        mid = port.comm_schedule(leader, 4, column_batch=16,
                                 link_bytes_per_us=base.wire_bytes / (2 * ring_tax))
        assert mid.mode == "pipelined", mid.reason
        starved = port.comm_schedule(leader, 4, column_batch=16, link_bytes_per_us=1e-9)
        assert starved.overlap_efficiency < 0.05 and starved.mode == "pipelined"


def test_comm_model_compute_uses_the_device_scale():
    """On the CPU the compute half is the reference's; a model bound to a
    CUDA device prices an element at ``WORK_ELEMENT_US_CUDA``."""
    plan = build_template_plan([get_template("u7")])
    g = rmat_graph(2048, 20_000, seed=1)
    cpu = cost.CostModel(plan, g, device="cpu")
    card = cost.CostModel(plan, g, fusion_slack=1.0, device="cuda")
    assert (cpu.platform, card.platform) == ("cpu", "cuda")
    for leader in cpu.tree_group_leaders():
        a = cpu.comm_schedule(leader, 4, column_batch=16)
        b = card.comm_schedule(leader, 4, column_batch=16)
        assert b.compute_us == pytest.approx(a.compute_us / 32)
        assert b.wire_bytes == a.wire_bytes and b.comm_us == a.comm_us


def test_mesh_memory_formulas_equal_reference():
    for names in (["u5-2"], ["u7"], ["path6", "star6", "u6"]):
        ref, port = _models(names, n=300, e=1500, seed=2)
        assert port.pick_mesh_column_batch() == ref.pick_mesh_column_batch()
        for args in ((300, 1700, 8), (1024, 5, 128), (2, 1, 1)):
            assert port.mesh_transient_elements(*args) == ref.mesh_transient_elements(*args)
        for rows in (75, 150):
            for cb in (8, 16, 128):
                for mode in ("streamed", "loop"):
                    assert port.mesh_resident_elements(rows, cb, mode) == \
                        ref.mesh_resident_elements(rows, cb, mode)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("comm", ["blocking", "pipelined"])
def test_predict_mesh_config_equals_reference(u7, n_shards, comm):
    ref, port = u7
    for cb in (None, 16):
        for chunk in (1, 8):
            want = ref.predict_config_us(
                RefTuningConfig(default_backend="mesh", column_batch=cb, mesh_comm=comm),
                chunk_size=chunk, calibration={"mesh": 1.7}, mesh_shards=n_shards)
            got = port.predict_config_us(
                TuningConfig(default_backend="mesh", column_batch=cb, mesh_comm=comm),
                chunk_size=chunk, calibration={"mesh": 1.7}, mesh_shards=n_shards)
            assert got == pytest.approx(want, rel=1e-12)


def test_candidate_lattice_mesh_axis_equals_reference(u7):
    ref, port = u7
    want = ref.candidate_lattice(calibration={}, mesh_shards=4)
    got = port.candidate_lattice(calibration={}, mesh_shards=4)

    def rows(cands):
        return [(c.config.key_fragment(), c.predicted_us, c.raw_us) for c in cands]

    assert rows(got) == rows(want)
    mesh = [c.config for c in got if c.config.default_backend == "mesh"]
    assert {c.mesh_comm for c in mesh} == {"blocking", "pipelined"}
    assert {c.memory_budget_bytes for c in mesh} == {
        cost.DEFAULT_MEMORY_BUDGET_BYTES, cost.DEFAULT_MEMORY_BUDGET_BYTES // 2}
    # without a ring size the lattice has no mesh candidate
    assert all(c.config.default_backend != "mesh" for c in port.candidate_lattice(calibration={}))


# -- the overrides ---------------------------------------------------------------


def test_mesh_comm_env_override(monkeypatch):
    for mod in (select, ref_select):
        monkeypatch.delenv(mod.MESH_COMM_ENV_VAR, raising=False)
        assert mod.mesh_comm_mode() is None
        for raw, want in (("pipelined", "pipelined"), ("BLOCKING ", "blocking"), ("ring", None)):
            monkeypatch.setenv(mod.MESH_COMM_ENV_VAR, raw)
            assert mod.mesh_comm_mode() == want
    assert select.MESH_COMM_ENV_VAR == ref_select.MESH_COMM_ENV_VAR


def test_mesh_link_env_override(monkeypatch):
    assert cost.mesh_link_bytes_per_us() == ref_cost.MESH_LINK_BYTES_PER_US == 4000.0
    for raw, want in (("250.5", 250.5), ("-3", 4000.0), ("fast", 4000.0)):
        monkeypatch.setenv(cost.MESH_LINK_ENV_VAR, raw)
        assert cost.mesh_link_bytes_per_us() == ref_cost.mesh_link_bytes_per_us() == want


# -- the shard layouts and the streamed tables -----------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("bucket", [False, True])
def test_shard_graph_equals_reference(n_shards, balance, bucket):
    for n, e, seed, kw in ((257, 1800, 3, {}), (400, 4000, 3, dict(a=0.7, b=0.12, c=0.12))):
        want = ref_shard_graph(ref_rmat(n, e, seed=seed, **kw), n_shards,
                               balance_degrees=balance, bucket_by_src=bucket)
        got = shard_graph(rmat_graph(n, e, seed=seed, **kw), n_shards,
                          balance_degrees=balance, bucket_by_src=bucket)
        for f in ("n", "n_padded", "n_shards", "rows_per_shard", "edges_per_shard",
                  "bucket_stride"):
            assert getattr(got, f) == getattr(want, f), f
        for f in ("src", "dst_local", "edge_mask", "perm"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("n_shards", [2, 4])
def test_bucket_by_src_layout_invariants(n_shards):
    g = rmat_graph(257, 1800, seed=3)
    sh = shard_graph(g, n_shards, bucket_by_src=True)
    assert sh.edges_per_shard == n_shards * sh.bucket_stride
    rows = sh.rows_per_shard
    src = sh.src.reshape(n_shards, n_shards, sh.bucket_stride)
    dst = sh.dst_local.reshape(n_shards, n_shards, sh.bucket_stride)
    mask = sh.edge_mask.reshape(n_shards, n_shards, sh.bucket_stride)
    total = 0
    for shard in range(n_shards):
        for owner in range(n_shards):
            m = mask[shard, owner] > 0
            total += int(m.sum())
            assert np.all(src[shard, owner][m] // rows == owner)
            assert np.all((0 <= dst[shard, owner][m]) & (dst[shard, owner][m] < rows))
    assert total == g.num_directed


@pytest.mark.parametrize("name", TEMPLATES)
@pytest.mark.parametrize("cb", [8, 16, 128])
def test_streamed_tables_equal_reference(name, cb):
    want = ref_streamed_tables(ref_build_plan(ref_template(name)), cb)
    got = build_streamed_tables(build_counting_plan(get_template(name)), cb)
    assert sorted(got) == sorted(want)
    for stage in want:
        for a, b in zip(got[stage], want[stage]):
            b = np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), stage


@pytest.mark.parametrize("name", ["u7", "u12"])
def test_run_slots_apply_each_entry_once_in_table_order(name):
    """The deterministic scatter: per batch, slot s holds each output's s-th
    entry, outputs unique per slot, and replaying the slots visits every
    table entry once, in (output, split) order per output."""
    plan = build_counting_plan(get_template(name))
    for stage, tables in build_streamed_tables(plan, 16).items():
        ent_out, ent_ia, ent_ip, ent_valid = tables
        for b, slots in enumerate(_run_slots(*tables, "cpu")):
            seen = {}
            for outs, ia, ip in slots:
                outs = outs.numpy()
                assert np.all(np.diff(outs) > 0)  # unique and ascending
                for o, x, y in zip(outs, ia.numpy(), ip.numpy()):
                    seen.setdefault(int(o), []).append((int(x), int(y)))
            c = int(ent_valid[b].sum())
            want = {}
            for o, x, y in zip(ent_out[b, :c], ent_ia[b, :c], ent_ip[b, :c]):
                want.setdefault(int(o), []).append((int(x), int(y)))
            assert seen == want, (stage, b)
