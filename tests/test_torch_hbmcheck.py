"""hbmcheck over the port (tpu_pbrt_torch/analysis/hbmcheck.py): the
counterparts of the reference's tests/test_hbmcheck.py where the subject
matches (the memory model, HC-CAP, HC-ACCT, HC-ALIAS, HC-LEAK, the
committed hbm_budgets.json gate, the derived caps), each rule's seeded
fixture, and the served film a real RenderService releases.

Where the port differs: the capacity table is the card's own memory
(committed from torch.cuda.get_device_properties by --derive-hbm-caps),
and the port has no buffer donation (its window writes the film in
place; HC-ALIAS counts each carry once).
"""

import json
import os

import numpy as np
import torch

from tpu_pbrt.analysis import hbmcheck as ref
from tpu_pbrt_torch.analysis import hbmcheck as hc
from tpu_pbrt_torch.integrators.common import live_film_carries

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SVC = "tpu_pbrt_torch/serve/service.py"
_RES = "tpu_pbrt_torch/serve/residency.py"


def _rules(src, rel):
    return [v.rule for v in hc.hc_leak_source(src, rel)]


class TestModel:
    def test_film_state_bytes_matches_live_layout_and_reference(self):
        # rgb (3) + weight (1) + splat (3) f32 planes: 28 B a pixel, as the
        # reference's FilmState
        assert hc.film_state_bytes(1, 1) == ref.film_state_bytes(1, 1) == 28
        assert hc.film_state_bytes(512, 512) == ref.film_state_bytes(512, 512)
        assert hc.film_state_bytes(2, 2) == 112  # the protocheck stub film

    def test_live_film_carries_as_the_reference(self):
        from tpu_pbrt.integrators.common import live_film_carries as ref_carries

        for d in (0, 1, 2, 3):
            assert live_film_carries(d) == ref_carries(d)

    def test_counter_bytes_from_the_live_layout(self):
        from tpu_pbrt_torch.obs import counters

        block = sum(t.numel() * t.element_size() for t in counters.zeros("cpu"))
        assert hc.COUNTER_BYTES_PER_SLICE == 4 * 8 + block == 88

    def test_job_bytes_closed_form(self):
        fb = hc.film_state_bytes(*hc.REF_FILM)
        assert hc.job_hbm_bytes(fb, 1) == fb + hc.COUNTER_BYTES_PER_SLICE
        assert hc.job_hbm_bytes(fb, 2) == 3 * fb + 2 * hc.COUNTER_BYTES_PER_SLICE

    def test_serve_model_totals_add_up(self):
        m = hc.serve_model()
        assert m["total_bytes"] == (m["resident_bytes"] + m["jobs_bytes"] + m["prefetch_bytes"]
                                    + m["staging_bytes"])
        assert m["jobs_bytes"] == m["max_active"] * m["job_bytes"]
        assert m["resident_bytes"] == 12288 * 10 ** 6  # the configured LRU budget


class TestHcCap:
    def test_committed_capacity_fits(self):
        cap = hc.capacity_table()
        assert cap and all(v > 40 * hc.GiB for v in cap.values())
        assert hc.check_capacity(hc.serve_model(), capacity=cap) == []

    def test_seeded_over_cap_named(self):
        m = hc.serve_model(resident_bytes=96 * hc.GiB)
        errs = hc.check_capacity(m, capacity=hc.capacity_table())
        assert len(errs) == 1 and errs[0].startswith("HC-CAP:")

    def test_over_cap_config_exits_nonzero_via_cli(self, monkeypatch, capsys):
        # the entry point under TORCH_PBRT_SERVE_RESIDENT_MB=98304 (the
        # config's value, read once at import)
        from tpu_pbrt_torch.config import cfg

        monkeypatch.setattr(cfg, "serve_resident_mb", 98304.0)
        assert hc._main([]) == 1
        assert "HC-CAP" in capsys.readouterr().out

    def test_session_check(self):
        assert hc.session_check(10, 5) == (2.0, [])
        ratio, errs = hc.session_check(5, 10)
        assert ratio == 0.5 and errs[0].startswith("HC-CAP:")

    def test_predicted_session_counts_the_working_set(self):
        """A solo render's working set (its peak above the model) carried
        into the served session's prediction: the prediction reaches a
        session peak that the model alone misses, and a seeded peak above
        it is flagged."""
        m = hc.serve_model(rx=128, ry=128, max_active=2, resident_bytes=50_000_000)
        solo_model = hc.render_model_bytes(128, 128)
        ws = hc.working_set_bytes(solo_model + 300_000_000, solo_model)
        assert ws == 300_000_000 and hc.working_set_bytes(1, solo_model) == 0
        pred = hc.predict_session(m, ws)
        assert pred == m["total_bytes"] + ws
        peak = m["total_bytes"] + ws // 2
        assert hc.session_check(m["total_bytes"], peak)[1]
        assert hc.session_check(pred, peak)[1] == []
        # a compile's transient above the jobs takes the place of their sum
        assert hc.predict_session(m, ws, compile_extra=10 ** 10) == m["resident_bytes"] + 10 ** 10
        assert hc.session_check(pred, pred + 1)[1][0].startswith("HC-CAP:")

    def test_headroom_check_flags_seeded_overflow(self):
        cap = {"card": 80 * hc.GiB}
        worst = hc.serve_model()["total_bytes"]
        share, errs = hc.headroom_check(worst, 2 * hc.GiB, hc.GiB, cap)
        assert errs == [] and 0 < share < hc.HBM_HEADROOM
        _, errs = hc.headroom_check(worst, 12 * hc.GiB, 5 * hc.GiB, cap)
        assert len(errs) == 1 and "headroom leaves" in errs[0]
        _, errs = hc.headroom_check(60 * hc.GiB, 4 * hc.GiB, 17 * hc.GiB, cap)
        assert len(errs) == 2 and all(e.startswith("HC-CAP:") for e in errs)


class TestHcAcct:
    def test_reference_scene_within_tolerance(self):
        assert hc.acct_check() == []

    def test_compiled_scene_estimate_is_exact(self):
        """On a compiled scene (a walker's tables included) the estimate
        equals the exact walk."""
        from tpu_pbrt_torch.config import cfg
        from tpu_pbrt_torch.scenes import compile_api, make_cornell
        from tpu_pbrt_torch.serve.residency import scene_hbm_bytes

        prev = cfg.bvh
        cfg.bvh = "wide"
        try:
            scene, _ = compile_api(make_cornell(res=8, spp=1, device="cpu"))
        finally:
            cfg.bvh = prev
        assert "wbvh" in scene.dev
        assert scene_hbm_bytes(scene) == hc.exact_scene_bytes(scene)
        assert hc.acct_check(scene) == []

    def test_seeded_lying_leaf_detected(self):
        # a leaf the estimator cannot see (shape and dtype, no tensor) is
        # counted by the exact walk: the estimate drifts and is caught
        class _Lying:
            shape = (1024, 1024)
            dtype = np.float32
            nbytes = 64

        sc = hc.reference_scene()
        sc.dev["liar"] = _Lying()
        errs = hc.acct_check(sc)
        assert len(errs) == 1 and errs[0].startswith("HC-ACCT:")

    def test_seeded_film_constant_drift_detected(self, monkeypatch):
        from tpu_pbrt_torch.serve import residency

        monkeypatch.setattr(residency, "FILM_BYTES_PER_PIXEL", 16)
        errs = hc.acct_check()
        assert errs and errs[0].startswith("HC-ACCT:") and "B/pixel" in errs[0]

    def test_exact_walk_is_shape_times_itemsize(self):
        sc = hc.reference_scene()
        leaves = list(hc._leaves(sc.dev))
        want = sum(int(np.prod(a.shape)) * a.element_size() for a in leaves)
        assert len(leaves) == 12
        assert hc.exact_scene_bytes(sc) == want + hc.film_state_bytes(*hc.REF_FILM)


class TestHcAlias:
    def test_clean_graphs_reproduce_closed_form(self):
        assert hc.alias_audit() == []

    def test_depth1_in_place_is_one_buffer(self):
        fb = hc.film_state_bytes(*hc.REF_FILM)
        bufs = hc.job_buffers(fb, 1)
        # the in-place output and the checkpoint's reference alias the film
        assert hc.dedup_bytes(bufs) == fb + hc.COUNTER_BYTES_PER_SLICE

    def test_seeded_in_place_without_alias_edge_flagged(self):
        bufs = [hc.Buf("film", 100), hc.Buf("film_out", 100, in_place=True)]
        errs = hc.check_alias(bufs)
        assert len(errs) == 1 and "double-count" in errs[0] and errs[0].startswith("HC-ALIAS:")

    def test_seeded_double_count_breaks_the_closed_form(self, monkeypatch):
        def doubled(film_bytes, depth, cadence=True):
            return [hc.Buf("film", film_bytes), hc.Buf("film_out", film_bytes)] + [
                hc.Buf(f"counters{i}", hc.COUNTER_BYTES_PER_SLICE) for i in range(depth)]

        monkeypatch.setattr(hc, "job_buffers", doubled)
        errs = hc.alias_audit((1,))
        assert errs and errs[0].startswith("HC-ALIAS:") and "double counted" in errs[0]

    def test_unresolvable_alias_flagged(self):
        errs = hc.check_alias([hc.Buf("snap", 100, alias_of="ghost")])
        assert len(errs) == 1 and "unknown buffer" in errs[0]


class TestHcLeak:
    def test_seeded_terminal_without_release_flagged(self):
        src = ("def fail(self, job):\n"
               "    job.status = FAILED\n"
               "    self.residency.unpin(job.resident_key)\n")
        vs = hc.hc_leak_source(src, _SVC)
        assert [v.rule for v in vs] == ["HC-LEAK"]
        assert "releases no device buffers" in vs[0].message

    def test_terminal_with_release_helper_clean(self):
        src = ("def fail(self, job):\n"
               "    job.status = FAILED\n"
               "    self._release_device(job)\n"
               "    self.residency.unpin(job.resident_key)\n")
        assert _rules(src, _SVC) == []

    def test_inline_release_requires_all_four_counter_lists(self):
        head = ("def fail(self, job):\n"
                "    job.status = CANCELLED\n"
                "    job.state = None\n"
                "    self.residency.unpin(job.resident_key)\n")
        partial = head + "    job.ray_counts.clear()\n    job.occ_counts.clear()\n"
        full = partial + "    job.ctr_counts.clear()\n    job.nf_counts.clear()\n"
        assert _rules(partial, _SVC) == ["HC-LEAK"]
        assert _rules(full, _SVC) == []

    def test_terminal_without_unpin_flagged(self):
        src = "def fin(self, job):\n    job.status = DONE\n    self._release_device(job)\n"
        vs = hc.hc_leak_source(src, _SVC)
        assert [v.rule for v in vs] == ["HC-LEAK"] and "pin" in vs[0].message

    def test_non_terminal_status_untouched(self):
        assert _rules("def park(self, job):\n    job.status = PARKED\n", _SVC) == []

    def test_outside_serve_modules_unscoped(self):
        src = "def fail(self, job):\n    job.status = FAILED\n"
        assert _rules(src, "tpu_pbrt_torch/core/film.py") == []

    def test_seeded_eviction_without_pin_check_flagged(self):
        bad = "def evict(self):\n    for k in list(self._entries):\n        del self._entries[k]\n"
        good = ("def evict(self):\n    for k, e in list(self._entries.items()):\n"
                "        if e.pins == 0:\n            del self._entries[k]\n")
        vs = hc.hc_leak_source(bad, _RES)
        assert [v.rule for v in vs] == ["HC-LEAK"] and "pin counts" in vs[0].message
        assert _rules(good, _RES) == []

    def test_pragma_suppression(self):
        src = "def fail(self, job):  # torchlint: disable=HC-LEAK\n    job.status = FAILED\n"
        assert _rules(src, _SVC) == []

    def test_syntax_error_is_a_finding_not_a_crash(self):
        assert _rules("def broken(:\n", _SVC) == ["HC-PARSE"]

    def test_repo_tree_is_clean(self):
        """The port's service (its single-device and mesh lead and follow
        paths) and residency module."""
        assert hc.hc_leak_tree() == []

    def test_seeded_leak_in_the_service_flagged(self, tmp_path):
        """A copy of the port's service whose cancel skips the release."""
        src = open(os.path.join(REPO, _SVC)).read()
        marker = "        job.status = CANCELLED\n        self._release_device(job)\n"
        assert marker in src
        mutant = tmp_path / _SVC
        mutant.parent.mkdir(parents=True)
        mutant.write_text(src.replace(marker, "        job.status = CANCELLED\n"))
        (tmp_path / _RES).write_text(open(os.path.join(REPO, _RES)).read())
        vs = hc.hc_leak_tree(str(tmp_path))
        assert [v.rule for v in vs] == ["HC-LEAK"] and "cancel" in vs[0].message


class TestBudgets:
    def test_committed_budgets_gate_clean(self):
        errs, _ = hc.check_budgets(hc.collect_entries(), hc.load_budgets())
        assert errs == []

    def test_missing_entry_is_an_error(self):
        errs, _ = hc.check_budgets(hc.collect_entries(), {"entries": {}})
        assert errs and all("no committed HBM budget" in e for e in errs)

    def test_regression_then_update_then_clean(self, tmp_path):
        p = tmp_path / "hbm_budgets.json"
        entries = hc.collect_entries()
        hc.save_budgets(entries, p, tolerance=0.1, capacity={"card": 10 ** 11})
        grown = {k: dict(v, hbm_bytes=v["hbm_bytes"] * 2) for k, v in entries.items()}
        errs, _ = hc.check_budgets(grown, hc.load_budgets(p))
        assert errs and all("regressed" in e for e in errs)
        shrunk = {k: dict(v, hbm_bytes=max(v["hbm_bytes"] // 2, 1)) for k, v in entries.items()}
        errs, warns = hc.check_budgets(shrunk, hc.load_budgets(p))
        assert errs == [] and warns
        hc.save_budgets(grown, p, tolerance=0.1)
        errs, warns = hc.check_budgets(grown, hc.load_budgets(p))
        assert errs == [] and warns == []
        doc = json.loads(p.read_text())
        assert doc["tolerance"] == 0.1 and doc["capacity"] == {"card": 10 ** 11}

    def test_stale_entry_warns(self, tmp_path):
        p = tmp_path / "hbm_budgets.json"
        entries = dict(hc.collect_entries())
        entries["serve.ghost"] = {"hbm_bytes": 1, "fingerprint": "x"}
        hc.save_budgets(entries, p)
        del entries["serve.ghost"]
        errs, warns = hc.check_budgets(entries, hc.load_budgets(p))
        assert errs == [] and any("serve.ghost" in w and "no live model term" in w
                                  for w in warns)

    def test_run_hbmcheck_repo_gate_clean(self):
        errors, _ = hc.run_hbmcheck()
        assert errors == []


class TestDeriveCaps:
    def test_derived_caps_admit_the_committed_defaults(self):
        from tpu_pbrt_torch.config import cfg

        d = hc.derive_hbm_caps()
        assert hc.check_hbm_caps(d) == []
        c = d["configured"]
        assert c["serve_resident_mb"] == cfg.serve_resident_mb == 12288.0
        assert c["pipeline_depth"] == cfg.pipeline == 2
        assert all(p["max_pipeline_depth"] >= cfg.pipeline for p in d["cards"].values())

    def test_caps_scale_with_memory(self):
        cap = next(iter(hc.capacity_table().values()))
        d = hc.derive_hbm_caps(capacity={"half": cap // 2, "full": cap})
        assert d["cards"]["half"]["max_active"] < d["cards"]["full"]["max_active"]

    def test_seeded_overcommitted_knobs_flagged_by_name(self):
        d = hc.derive_hbm_caps()
        d["configured"]["serve_resident_mb"] = 1e9
        d["configured"]["pipeline_depth"] = 10_000
        errs = hc.check_hbm_caps(d)
        assert len(errs) == 2 and all(e.startswith("HC-CAP:") for e in errs)

    def test_cli_without_a_card_derives_from_the_committed_table(self, capsys):
        assert not torch.cuda.is_available()
        assert hc._main(["--derive-hbm-caps", "--format", "json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["configured"]["serve_resident_mb"] == 12288.0
        assert set(doc["cards"]) == set(hc.capacity_table())


def test_analysis_suite_runs_hbmcheck(capsys, monkeypatch):
    """`python -m tpu_pbrt_torch.analysis` runs hbmcheck unless asked not
    to (the hbmcheck stage beside the lint of one file here; a seeded
    over-budget config fails the suite)."""
    from tpu_pbrt_torch.analysis.__main__ import main
    from tpu_pbrt_torch.config import cfg

    one = [os.path.join(REPO, "tpu_pbrt_torch", "analysis", "hbmcheck.py"), "--no-audit",
           "--no-cost"]
    assert main(one + ["--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["hbmcheck"] == {"errors": [], "warnings": []}
    monkeypatch.setattr(cfg, "serve_resident_mb", 98304.0)
    assert main(one) == 1
    assert "HBM [error]: HC-CAP" in capsys.readouterr().out
    assert main(one + ["--no-hbmcheck"]) == 0


def test_served_job_releases_its_film_on_cancel_and_done():
    """The dynamic side of HC-LEAK on a real RenderService over the stub
    harness: a cancelled job and a finished one hold no film state, no
    counter and no pin."""
    from tpu_pbrt_torch.analysis.protocheck import _harness
    from tpu_pbrt_torch.serve import RenderService
    from tpu_pbrt_torch.utils.clock import VirtualClock

    h = _harness()
    svc = RenderService(clock=VirtualClock(), device="cpu", spool_dir=None)
    jobs = [svc.submit(compiled=(h["StubScene"](), h["StubIntegrator"](4, 2)),
                       resident_key="stub", tenant=t) for t in ("a", "b")]
    svc.step()
    svc.cancel(jobs[0])
    svc.drain()
    assert [svc.jobs[j].status for j in jobs] == ["cancelled", "done"]
    for j in jobs:
        job = svc.jobs[j]
        assert job.state is None and not job.window
        assert not (job.ray_counts or job.occ_counts or job.ctr_counts or job.nf_counts)
    assert not any(svc.residency.pin_counts().values())
