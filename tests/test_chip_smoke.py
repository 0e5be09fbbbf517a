"""chip_smoke.py's phases on a 2,000-passage corpus on the CPU backend:
the gates run against the numpy reference without the GPU check, and
the script refuses to report a result off the GPU."""

from types import SimpleNamespace

import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    ctx = SimpleNamespace()
    cs.phase_env(ctx, require_gpu=False)
    cs.phase_ingest(ctx, 2000, str(tmp_path_factory.mktemp("main")),
                    chunk=700)
    cs.phase_open(ctx)
    return ctx


def test_env_refuses_cpu_backend():
    with pytest.raises(cs.GateError, match="not 'gpu'"):
        cs.phase_env(SimpleNamespace())


def test_main_prints_no_result_off_gpu(capsys):
    with pytest.raises(cs.GateError):
        cs.main(["--docs", "100"])
    assert '"ok"' not in capsys.readouterr().out


def test_open_places_segments_on_default_backend(ctx):
    assert cs.check_placement(ctx, ctx.reader) > 0
    assert [len(d) for d in ctx.docnum] == [
        s.doc_count for s in ctx.reader.segments]


def test_search_phase_gates_stream_and_aggs(ctx):
    cs.phase_search(ctx, batch=64, n_batches=2, n_singles=8)


def test_gate_catches_a_wrong_answer(ctx):
    q = cs.make_queries(ctx, 1)[0]
    hits = cs.result_hits(ctx.oracle,
                          ctx.reader.search({"query": q, "limit": 10}))
    ref = cs.Reference(ctx.oracle.scores(q.split()), 10)
    assert ref.check(hits) is None
    assert ref.check(hits[1:]) is not None
    si, o, s = hits[0]
    assert ref.check([(si, o, s * 1.05)] + hits[1:]) is not None


def test_surface_phase(ctx, tmp_path):
    cs.phase_surface(ctx, 600, str(tmp_path / "surface"), dim=16,
                     chunk=250)


def test_http_phase(ctx):
    cs.phase_http(ctx)


def test_four_phase_on_virtual_devices(ctx):
    cs.phase_four(ctx, batch=32, n_batches=2, n_devices=4)
