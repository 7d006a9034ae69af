"""`fmt-visualizer` and `recipient-visualiser` end to end against the JAX
package: both packages run in-process through runner.main on the seeded
inputs of torch_fmt_data.fmt_data, outputs compared byte for byte.
"""
import pytest

from torch_fmt_data import fmt_data, run_both


@pytest.mark.parametrize("k", [21, 33])
def test_fmt_visualizer_byte_identical_to_jax(fmt_data, k, tmp_path,
                                              monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    got = run_both(fmt_data, "fmt-visualizer", k, tmp_path)
    for sub in ("donor", "before", "after"):
        assert f"{sub}/comp0.gfa" in got and f"{sub}/comp0_seqs.fasta" in got


@pytest.mark.parametrize("k,extra", [
    (21, ("--maxradius", "40")), (21, ("--maxkmers", "60")),
    (33, ("--maxradius", "30")), (21, ()),
], ids=["k21-radius", "k21-maxkmers", "k33-radius", "k21-default-radius"])
def test_recipient_visualiser_byte_identical_to_jax(fmt_data, k, extra,
                                                    tmp_path, monkeypatch):
    """s2 is absent from the after metagenome: no files for it."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.delenv("MC_DEVICE_CONTRACT", raising=False)
    got = run_both(fmt_data, "recipient-visualiser", k, tmp_path, *extra)
    assert sorted(got) == sorted(f"after/comp_{i}{s}" for i in (0, 1)
                                 for s in (".gfa", "_seqs.fasta"))
    assert "_start" in got["after/comp_0_seqs.fasta"].decode()
