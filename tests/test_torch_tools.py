"""The port's tools (``hplflownet_tpu_torch.tools``) on the CPU, at toy
shapes.

Each tool's entry point runs with ``--device cpu``: the kernels' plain
versions, host-clock times (no device number).  What this checks is the
tools themselves: arguments, shapes, the cases they time, their in-run
checks and the JSON line they print last.  The timer's device rule, the
shared constants and the kernel paths the tools reach are checked too.
"""

import json

import pytest
import torch

import chip_smoke
from hplflownet_tpu_torch.tools import (gather_lab, kernel_ab, microbench,
                                        rank_partial_lab, step_calls, timing)

TOY = ["--device", "cpu", "--points", "128", "--capacities", "1024", "2048",
       "2048", "1024", "512", "256", "128", "--reps", "1", "--warmup", "0"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_microbench_entry_point_on_the_cpu(capsys):
    out = microbench.main(TOY + ["--width-div", "8", "--sort-sizes", "4096"])
    assert _last_json(capsys) == json.loads(json.dumps(out))
    assert out["clock"] == "host clock" and out["device"] == "cpu"
    names = list(out["ms"])
    assert len(names) == 5 + 2 + 2 + 4 + 3 + 2
    for prefix in ("blur_down_s0 (1024,", "blur_up_s0 (1024,72->128)",
                   "matmul (1024,1080)@(1080,128)", "corr_cross_s2",
                   "corr_gather1_adjoint_s2", "splat_s0", "slice_s0",
                   "sort64_stable x4096"):
        assert any(n.startswith(prefix) for n in names), prefix
    assert all(v > 0 for v in out["ms"].values())


def test_gather_lab_entry_point_on_the_cpu(capsys):
    out = gather_lab.main(TOY + ["--widths", "8", "16"])
    assert _last_json(capsys)["tool"] == "gather_lab"
    assert out["take_equal"] and out["take_shape"] == [1024, 128]
    assert len(out["ms"]) == 3 * 2 + 2
    assert "row_take (1025,128) bf16, one tap" in out["ms"]


def test_rank_partial_lab_entry_point_on_the_cpu(capsys):
    out = rank_partial_lab.main(["--device", "cpu", "--sizes", "1280", "640",
                                 "--bos", "8", "2", "--reps", "1",
                                 "--warmup", "0"])
    assert _last_json(capsys)["tool"] == "rank_partial_lab"
    assert len(out["ms"]) == 2 * (2 * 2 + 2)
    # plain versions against themselves on the CPU: exact
    assert out["max_abs_err"] and not any(out["max_abs_err"].values())


def test_lab_stream_ranks_follow_the_block_local_ranks():
    gen = torch.Generator().manual_seed(0)
    g, meta, grank, lane = rank_partial_lab.lab_stream(1000, 6, 4, gen, "cpu")
    assert g.shape == (1000, 10) and g.dtype == torch.bfloat16
    lrank = meta & 0xFFFF
    assert bool((lane == meta >> 16).all()) and int(lane.max()) < 4
    # a new global rank at every local-rank change and every block start
    new = torch.ones(1000, dtype=torch.bool)
    new[1:] = (lrank[1:] != lrank[:-1]) | (torch.arange(1, 1000) % 128 == 0)
    assert torch.equal(grank, torch.cumsum(new.int(), 0).int() - 1)


def test_timer_and_constants(monkeypatch):
    assert timing.SFM7 == chip_smoke.SFM7
    assert timing.CAPACITIES == chip_smoke.CAPACITIES
    assert timing.NUM_POINTS == chip_smoke.NUM_POINTS
    calls = []
    assert timing.time_ms(lambda: calls.append(1), "cpu", reps=3, warmup=2) >= 0
    assert len(calls) == 5
    assert timing.clock_name("cpu") == "host clock"
    assert timing.card_line("cpu").startswith("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        microbench.run(reps=1)


def test_step_calls_record_groups_calls_by_shape_and_restores_the_ops():
    from hplflownet_tpu_torch.ops import corr, segment
    before = (segment.rank_reduce, corr.stencil_tap_tables_sum)
    g = torch.randn(12, 7)
    rid = torch.zeros(12, dtype=torch.int32)
    start = torch.tensor([0, 4], dtype=torch.int32)
    end = torch.tensor([4, 12], dtype=torch.int32)
    nb = torch.tensor([[0, -1, 2], [1, 1, -1]], dtype=torch.int32)
    tabs = torch.randn(3, 2 * 4)
    with step_calls.record() as found:
        a = segment.rank_reduce(g, rid, start, end, 5, True)
        segment.rank_reduce(g, rid, start, end, 5, with_weights=True)
        segment.rank_reduce(g[:, :5].contiguous(), None, start, end, 5)
        b = corr.stencil_tap_tables_sum(tabs, 4, nb)
    assert (segment.rank_reduce, corr.stencil_tap_tables_sum) == before
    # calls pass through unchanged
    torch.testing.assert_close(a, segment.rank_reduce(g, rid, start, end, 5, True))
    torch.testing.assert_close(b, corr.stencil_tap_tables_sum(tabs, 4, nb))
    assert [(grp["key"], grp["launches"]) for grp in found["rank_reduce"]] == [
        (dict(M=12, C=5, R=2, T=2, with_weights=True, dtype="float32"), 2),
        (dict(M=12, C=5, R=0, T=2, with_weights=False, dtype="float32"), 1)]
    assert found["rank_reduce"][0]["args"]["g"] is g
    assert [(grp["key"], grp["launches"])
            for grp in found["stencil_tap_tables_sum"]] == [
        (dict(H=3, F=2, C=4, H_out=3, dtype="float32"), 1)]


def test_kernel_ab_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        kernel_ab.run(str(tmp_path))
    assert timing.graph_ms(lambda: None, "cpu") >= 0
