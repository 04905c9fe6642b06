"""The port's analytic roofline (``repro_torch.launch.roofline``,
``sharding``, ``report``) against the reference's ``repro.launch``.

``param_counts`` counts the port's own parameter trees (built on the meta
device) and equals the reference's ``eval_shape`` count for all ten archs,
MoE active counts included (the counterpart of
``tests/test_roofline.py::test_param_counts_exact`` and
``test_moe_active_counts``). Given the reference's own constants (imported
from ``repro.launch.roofline``, its device counts and a ``Chip`` of its
peak rates) and its ``make_plan`` on a mesh stub, the port's train, prefill
and decode terms are the reference's floats exactly; the port's
``make_plan`` is the reference's, and ``report.table`` renders the same
string. The port's own chip is the H100."""
import dataclasses

import pytest

from repro.configs import common as JCommon
from repro.launch import report as JReport
from repro.launch import roofline as JR
from repro.launch import sharding as JS
from repro_torch.configs import common as TCommon
from repro_torch.launch import report as TReport
from repro_torch.launch import roofline as TR
from repro_torch.launch import sharding as TS

ARCHS = JCommon.list_archs()


class _Single:  # the reference's stub mesh (tests/test_roofline.py)
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class _Multi:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


REF_CHIP = TR.Chip("reference", JR.PEAK_FLOPS, JR.HBM_BW, JR.ICI_BW)


def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in TCommon.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JCommon.SHAPES.items()}


@pytest.mark.parametrize("arch_id", ARCHS)
def test_param_counts_equal_reference(arch_id):
    got = TR.param_counts(TCommon.get_arch(arch_id))
    want = JR.param_counts(JCommon.get_arch(arch_id))
    assert got == want
    if arch_id == "qwen2_0_5b":
        assert 0.4e9 < got["total"] < 0.6e9 and got["active"] == got["total"]
    if arch_id == "granite_moe_1b_a400m":
        frac = (got["active"] - (got["total"] - got["expert"])) / \
            got["expert"]
        assert got["expert"] > 0 and abs(frac - 8 / 32) < 1e-6


def _terms_dict(t):
    return {"flops": t.flops_per_dev, "hbm": t.hbm_bytes_per_dev,
            "coll": t.coll_bytes_per_dev, "model": t.model_flops_total,
            "devices": t.devices, "seconds": t.seconds(),
            "dominant": t.dominant(), "fraction": t.roofline_fraction()}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_terms_equal_reference_given_its_constants(arch_id, multi_pod):
    ja, ta = JCommon.get_arch(arch_id), TCommon.get_arch(arch_id)
    mesh = _Multi() if multi_pod else _Single()
    for shape_name, shape in JCommon.SHAPES.items():
        plan = JS.make_plan(ja, shape, mesh)
        assert dataclasses.asdict(TS.make_plan(
            ta, TCommon.SHAPES[shape_name], mesh)) == \
            dataclasses.asdict(plan)
        want = JR.terms_for(ja, shape, plan, 8e9, multi_pod)
        got = TR.terms_for(ta, TCommon.SHAPES[shape_name], plan, 8e9,
                           JR.DEVICES[multi_pod], REF_CHIP)
        assert _terms_dict(got) == _terms_dict(want), shape_name


def test_report_table_equals_reference():
    res = [TR.analyze("qwen2_0_5b", "train_4k", 2),
           TR.analyze("granite_moe_1b_a400m", "decode_32k", 1),
           TR.analyze("xlstm_350m", "prefill_32k", 4),
           {"label": "jamba/long_500k", "skipped": "does not fit"},
           {"label": "a/b", "error": "x" * 100}]
    assert TReport.table(res) == JReport.table(res)
    assert TReport.fmt_bytes(None) == JReport.fmt_bytes(None) == "-"
    for b in (0, 1023, 1 << 20, 3 << 40, 1 << 60):
        assert TReport.fmt_bytes(b) == JReport.fmt_bytes(b)
    for x in (None, 1e-7, 5e-3, 2.5):
        assert TReport.fmt_s(x) == JReport.fmt_s(x)


def test_h100_constants_and_cli(capsys):
    """The port's one chip carries H100 rates only; the CLI prints the
    qwen2-0.5B train cell at D = 2, whose collective term is the busiest
    rank's reduce bytes: two f32 accumulators of d padded to the tile and
    two f32 losses."""
    assert (TR.H100.peak_flops, TR.H100.hbm_bw, TR.H100.link_bw) == \
        (989.4e12, 3.35e12, 450e9)
    TR.main(["--arch", "qwen2_0_5b", "--shape", "train_4k", "--devices",
             "2"])
    import json
    out = json.loads(capsys.readouterr().out)
    assert out["chip"] == "H100 SXM 80GB" and out["devices"] == 2
    assert out["coll_bytes_per_dev"] == 2 * 4 * 494_034_944 + 2 * 4
    assert out["plan"]["n_clients"] == 2
    assert out["dominant"] == "compute"
    assert 0.0 < out["roofline_fraction"] <= 1.0


def test_cohort_plan_and_round_context():
    assert dataclasses.asdict(TS.cohort_plan(16, client_groups=2, micro=4,
                                             local_steps=2)) == \
        dataclasses.asdict(JS.cohort_plan(16, client_groups=2, micro=4,
                                          local_steps=2))
    ctx = TS.round_context(TS.cohort_plan(8), cohort="stream(shard=4)",
                           adversary="dropout(f=1)")
    jctx = JS.round_context(JS.cohort_plan(8), cohort="stream(shard=4)",
                            adversary="dropout(f=1)")
    for f in ("agg_backend", "encode_backend", "weights_are_mask",
              "dynamic_sigma", "cohort", "adversary"):
        assert getattr(ctx, f) == getattr(jctx, f), f
