"""The port's AST lint (tpu_pbrt_torch/analysis/lint.py), the counterpart of
tests/test_jaxlint.py: each rule flags its seeded fixture and passes its
near miss, the hot set propagates through helper calls, pragmas scope as
the reference's do, and the shipped tree lints clean with exactly its
pragma budget (one pragma per sanctioned host read)."""

import textwrap
from pathlib import Path

import pytest
import torch

from tpu_pbrt_torch.analysis.lint import (ALLOWLIST, HOT_SEEDS, PRAGMA_BUDGET, RULES,
                                          hot_functions, lint_file, lint_tree)

torch.set_num_threads(1)


def _lint_src(tmp_path: Path, src: str, seeds=("wave",), name="mod.py"):
    pkg = tmp_path / "tpu_pbrt_torch"
    pkg.mkdir(exist_ok=True)
    f = pkg / name
    f.write_text(textwrap.dedent(src))
    return lint_file(f, tmp_path, seeds=seeds)


def _rules(vs):
    return sorted({v.rule for v in vs})


#: rule -> (a hot-set fixture it must flag, the near miss it must pass)
FIXTURES = {
    "JL-SYNC": (
        """
        import torch

        def wave(x, lane):
            n = int((x > 0).sum())
            live = lane.alive.any()
            if bool(live):
                return x.tolist(), n
        """,
        """
        import torch

        def wave(x, n_work: int, cfg):
            slab = int(min(max(n_work // 4, 4096), cfg.slab))
            k = int(x.shape[0])
            return torch.zeros((k,), dtype=torch.int32), float(slab)
        """,
    ),
    "JL-F64": (
        """
        import torch

        def wave(x):
            return x.double() + torch.zeros(3, dtype=torch.float64)
        """,
        """
        import torch

        def wave(x):
            return x.float()

        def host_table(x):
            return x.double()
        """,
    ),
    "JL-DTYPE": (
        """
        import torch

        def wave(x):
            return torch.arange(x.shape[0], device=x.device) + torch.full((4,), 1)
        """,
        """
        import torch

        def wave(x):
            return torch.arange(x.shape[0], dtype=torch.int32, device=x.device) + \\
                torch.zeros_like(x)
        """,
    ),
    "JL-ENV": (
        """
        import os

        def knob():
            return os.environ.get("TORCH_PBRT_X", "1")
        """,
        """
        from tpu_pbrt_torch.config import cfg

        def knob():
            return cfg.chunk
        """,
    ),
}


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_flags_fixture_and_passes_near_miss(tmp_path, rule):
    bad, good = FIXTURES[rule]
    vs, _ = _lint_src(tmp_path, bad)
    assert _rules(vs) == [rule], [str(v) for v in vs]
    vs, _ = _lint_src(tmp_path, good)
    assert vs == [], [str(v) for v in vs]


def test_sync_fixture_finds_every_read(tmp_path):
    vs, _ = _lint_src(tmp_path, FIXTURES["JL-SYNC"][0])
    assert [v.line for v in vs] == [5, 7, 8]


def test_hot_set_propagates_through_helper_calls(tmp_path):
    """A helper reachable from the hot set is hot; the same code outside
    it (host-side setup) is not."""
    vs, _ = _lint_src(tmp_path, """
        import torch

        def helper(x):
            return x.item()

        def wave(x):
            return helper(x)

        def host_setup(x):
            return x.item()
        """)
    assert [(v.rule, v.line) for v in vs] == [("JL-SYNC", 5)]


def test_xla_math_f64_forms_are_allowed(tmp_path):
    pkg = tmp_path / "tpu_pbrt_torch" / "core"
    pkg.mkdir(parents=True)
    f = pkg / "xla_math.py"
    f.write_text(textwrap.dedent("""
        def _fma_f64(a, b, c):
            return (a.double() * b + c).float()

        def fma32(a, b, c):
            return _fma_f64(a, b, c)

        def other(a):
            return a.double()
        """))
    vs, _ = lint_file(f, tmp_path, seeds=("fma32", "other"))
    assert [(v.rule, v.line) for v in vs] == [("JL-F64", 9)]


def test_env_allowlist_has_reasons(tmp_path):
    for rule, files in ALLOWLIST.items():
        assert all(reason for reason in files.values()), rule
    pkg = tmp_path / "tpu_pbrt_torch" / "kernels"
    pkg.mkdir(parents=True)
    f = pkg / "build.py"
    f.write_text("import os\nHOME = os.environ.get('CUDA_HOME')\n")
    assert lint_file(f, tmp_path)[0] == []


class TestPragmas:
    def test_line_pragma_suppresses(self, tmp_path):
        vs, n = _lint_src(tmp_path, """
            def wave(x):
                return x.item()  # torchlint: disable=JL-SYNC
            """)
        assert vs == [] and n == 1

    def test_def_line_pragma_covers_body(self, tmp_path):
        vs, n = _lint_src(tmp_path, """
            def wave(x):  # torchlint: disable=JL-SYNC
                a = x.item()
                return x.tolist(), a
            """)
        assert vs == [] and n == 1

    def test_file_pragma(self, tmp_path):
        vs, n = _lint_src(tmp_path, """
            # torchlint: disable-file=JL-ENV
            import os
            A = os.environ.get("X")
            B = os.environ.get("Y")
            """)
        assert vs == [] and n == 1

    def test_pragma_in_docstring_is_not_a_pragma(self, tmp_path):
        vs, n = _lint_src(tmp_path, '''
            """Docs: use `# torchlint: disable=JL-SYNC` to suppress."""
            import os
            A = os.environ.get("X")
            ''')
        assert _rules(vs) == ["JL-ENV"] and n == 0

    def test_pragma_does_not_mute_other_rules(self, tmp_path):
        vs, _ = _lint_src(tmp_path, """
            def wave(x):
                return x.item()  # torchlint: disable=JL-F64
            """)
        assert _rules(vs) == ["JL-SYNC"]


class TestRepoGate:
    def test_repo_lints_clean_with_pragma_budget(self):
        """The shipped tree: no error, and one pragma per sanctioned host
        read (PRAGMA_BUDGET of them, listed beside it)."""
        violations, pragmas = lint_tree()
        errors = [v for v in violations if v.severity == "error"]
        assert errors == [], "\n".join(str(v) for v in errors)
        assert pragmas == PRAGMA_BUDGET

    def test_hot_set_holds_the_wave_and_not_the_host_side(self):
        hot = set(hot_functions())
        for mod, names in HOT_SEEDS.items():
            for name in names:
                assert f"{mod}:{name}" in hot
        for must in ("tpu_pbrt_torch/accel/stream.py:_traverse",
                     "tpu_pbrt_torch/kernels/flush.py:flush_chunk",
                     "tpu_pbrt_torch/core/bxdf.py:bsdf_sample"):
            assert must in hot
        assert not [h for h in hot if h.startswith(("tpu_pbrt_torch/serve/",
                                                    "tpu_pbrt_torch/analysis/"))]

    def test_parse_error_uses_dedicated_rule(self, tmp_path):
        pkg = tmp_path / "tpu_pbrt_torch"
        pkg.mkdir()
        f = pkg / "broken.py"
        f.write_text("def f(:\n")
        assert [v.rule for v in lint_file(f, tmp_path)[0]] == ["JL-PARSE"]

    def test_path_outside_repo_does_not_crash(self, tmp_path):
        f = tmp_path / "loose.py"
        f.write_text("import os\nA = os.environ.get('X')\n")
        assert [v.rule for v in lint_file(f, tmp_path / "elsewhere")[0]] == ["JL-ENV"]

    def test_rule_registry_documented(self):
        import tpu_pbrt_torch.analysis.lint as lint

        readme = (Path(__file__).resolve().parents[1] / "README.md").read_text()
        for rule in RULES:
            assert rule in lint.__doc__ or rule == "JL-PARSE", rule
            assert rule in readme or rule == "JL-PARSE", f"{rule} missing from README"
