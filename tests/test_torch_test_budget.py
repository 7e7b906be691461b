"""orbslam2_tpu_torch/tools/test_budget.py on a junit XML written here: the
whole run's and the port's case seconds, files and node ids taken from
``classname``, the slowest first, and a JSON line from the command line."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "orbslam2_tpu_torch", "tools", "test_budget.py")

XML = """<?xml version="1.0" encoding="utf-8"?>
<testsuites><testsuite name="pytest" errors="0" failures="0" skipped="0" tests="5">
<testcase classname="tests.test_ba" name="test_solve" time="4.5"/>
<testcase classname="tests.test_torch_slice" name="test_lost[lateral]" time="30.25"/>
<testcase classname="tests.test_torch_slice" name="test_lost[forward]" time="0.75"/>
<testcase classname="tests.test_torch_mapstate.TestMapState" name="test_slots" time="2.0"/>
<testcase classname="tests.test_torch_mapstate.TestMapState" name="test_erase" time="1.0"/>
</testsuite></testsuites>
"""


@pytest.fixture
def xml(tmp_path):
    path = tmp_path / "run.xml"
    path.write_text(XML)
    return str(path)


def _tool():
    import importlib.util
    spec = importlib.util.spec_from_file_location("test_budget", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_budget_sums_the_port_and_the_whole_run(xml):
    got = _tool().budget(xml, top=2)
    assert got["total_s"] == 38.5 and got["cases"] == 5 and got["files"] == 3
    assert got["port_s"] == 34.0 and got["port_cases"] == 4 and got["port_files"] == 2
    assert got["port_share"] == round(34.0 / 38.5, 4)
    assert got["slowest_files"] == [
        dict(file="tests/test_torch_slice.py", s=31.0, cases=2, port=True),
        dict(file="tests/test_ba.py", s=4.5, cases=1, port=False)]
    assert got["slowest_cases"] == [
        dict(id="tests/test_torch_slice.py::test_lost[lateral]", s=30.25),
        dict(id="tests/test_ba.py::test_solve", s=4.5)]
    ids = [c["id"] for c in _tool().budget(xml, top=5)["slowest_cases"]]
    assert "tests/test_torch_mapstate.py::TestMapState::test_slots" in ids


def test_budget_prints_one_json_line_and_imports_no_jax(xml):
    probe = ("import runpy, sys; sys.argv = ['test_budget.py', sys.argv[1], '--top', '1'];"
             f"runpy.run_path({TOOL!r}, run_name='__main__');"
             "assert not any(m == 'jax' or m.startswith(('jax.', 'orbslam2_tpu'))"
             " for m in sys.modules), 'imported jax'")
    proc = subprocess.run([sys.executable, "-c", probe, xml], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got["port_s"] == 34.0 and len(got["slowest_files"]) == 1
