"""The port's committed API reference (docs/torch/api) and the generated
tables of docs/torch/details.md must match a fresh regeneration by
``spfft_tpu_torch/programs/gen_api_docs.py``: a drifted page means an API
change shipped without regenerating. The JAX package's reference
(docs/api) is its own test's (tests/test_api_docs.py) and is left alone."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GEN = ROOT / "spfft_tpu_torch" / "programs" / "gen_api_docs.py"
TABLES = ("knob", "metric", "fault-site", "verify-check")


def test_api_reference_is_current(tmp_path):
    out = tmp_path / "api"
    r = subprocess.run([sys.executable, str(GEN), str(out)], capture_output=True,
                       text=True, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    committed = ROOT / "docs" / "torch" / "api"
    fresh = {p.name: p.read_text() for p in out.glob("*.md")}
    existing = {p.name: p.read_text() for p in committed.glob("*.md")}
    assert fresh.keys() == existing.keys(), (
        sorted(fresh.keys() ^ existing.keys()),
        "page set drifted — rerun spfft_tpu_torch/programs/gen_api_docs.py",
    )
    stale = [name for name in fresh if fresh[name] != existing[name]]
    assert not stale, f"stale API pages {stale} — rerun spfft_tpu_torch/programs/gen_api_docs.py"


def test_details_tables_are_current():
    code = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('gen', {str(GEN)!r})\n"
        "gen = importlib.util.module_from_spec(spec); spec.loader.exec_module(gen)\n"
        "print(json.dumps({'knob': gen.knob_table(), 'metric': gen.metric_table(),\n"
        "                  'fault-site': gen.fault_site_table(),\n"
        "                  'verify-check': gen.verify_check_table()}))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    fresh = json.loads(r.stdout.splitlines()[-1])
    text = (ROOT / "docs" / "torch" / "details.md").read_text()
    for name in TABLES:
        begin = text.index(f"<!-- {name}-table:begin")
        begin = text.index("-->", begin) + len("-->\n")
        end = text.index(f"<!-- {name}-table:end -->")
        assert text[begin:end].strip() == fresh[name].strip(), (
            f"the {name} table of docs/torch/details.md is stale — rerun "
            "spfft_tpu_torch/programs/gen_api_docs.py")
    for site in ("engine.execute", "serve.admit", "hlo.stats"):
        assert f"`{site}`" in fresh["fault-site"]
