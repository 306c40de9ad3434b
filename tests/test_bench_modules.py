"""Smoke tests for the bench harness that drives the distributed joins
(tiny sizes, CPU mesh)."""


def test_scalebench_smoke(capsys):
    from avx_sort_merge_joins_tpu.bench import scalebench
    assert scalebench.main(["20000", "--devices", "1,2", "--reps", "1"]) == 0
    cap = capsys.readouterr()  # single snapshot: a second call is empty
    assert "efficiency" in cap.err or cap.out.count("\n") >= 2


def test_scalebench_algorithms(capsys):
    from avx_sort_merge_joins_tpu.bench import scalebench
    for algo in ("m-pass", "mpsm"):
        assert scalebench.main(["20000", "--devices", "2", "--reps", "1",
                                "--algo", algo]) == 0
    rows = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert [r.split()[0] for r in rows] == ["m-pass", "mpsm"]
