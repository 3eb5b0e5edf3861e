"""Fault-site coverage of the port (``bin/dstpu_chaos_coverage``'s
counterpart): every site in the port's ``FaultInjector.SITES`` must be
exercised by at least one ``tests/test_torch_*.py``, by its name or one of
its arming keys (the gate's ``ARMING_KEYS``, read from the script so the two
stay in lockstep), on a word boundary. This file is left out of the corpus:
it names no site itself, and a gate must not be its own evidence.
"""

import importlib.machinery
import importlib.util
import os
import re

from deepspeed_tpu_torch.resilience.faults import FaultInjector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gate():
    path = os.path.join(REPO, "bin", "dstpu_chaos_coverage")
    loader = importlib.machinery.SourceFileLoader("_dstpu_chaos_coverage_bin", path)
    mod = importlib.util.module_from_spec(importlib.util.spec_from_loader(loader.name, loader))
    loader.exec_module(mod)
    return mod


def port_coverage(tests_dir, sites, arming_keys):
    """{site: [test_torch_*.py files with word-boundary evidence]}."""
    me = os.path.basename(__file__)
    texts = {}
    for name in sorted(os.listdir(tests_dir)):
        if name.startswith("test_torch_") and name.endswith(".py") and name != me:
            with open(os.path.join(tests_dir, name), encoding="utf-8") as f:
                texts[name] = f.read()
    hits = {}
    for site in sites:
        tokens = (site,) + tuple(arming_keys.get(site, ()))
        pat = re.compile(r"\b(?:" + "|".join(re.escape(t) for t in tokens) + r")\b")
        hits[site] = [n for n, text in texts.items() if pat.search(text)]
    return hits


def test_every_port_fault_site_is_exercised_by_a_port_test():
    gate = _gate()
    assert set(gate.ARMING_KEYS) == set(FaultInjector.SITES)
    hits = port_coverage(os.path.join(REPO, "tests"), FaultInjector.SITES, gate.ARMING_KEYS)
    missing = [s for s, files in hits.items() if not files]
    assert not missing, f"UNEXERCISED by tests/test_torch_*.py: {missing}"


def test_coverage_flags_an_unexercised_site(tmp_path):
    gate = _gate()
    sites = FaultInjector.SITES
    (tmp_path / "test_torch_only_one.py").write_text(f"# arms {gate.ARMING_KEYS[sites[5]][0]}\n")
    (tmp_path / "test_other.py").write_text(" ".join(sites))  # not a port test: no evidence
    hits = port_coverage(str(tmp_path), sites, gate.ARMING_KEYS)
    assert [s for s in sites if hits[s]] == [sites[5]]
    assert hits[sites[5]] == ["test_torch_only_one.py"]
