"""``chip_smoke.py``'s options on a machine without a card: ``--only`` picks
one kernel source's checks, ``--baseline`` an earlier copy of that source to
time in turns, and the script refuses to run (exit 2, no result) without
CUDA. The checks themselves run only on the card."""

import pytest
import torch

import chip_smoke


@pytest.mark.parametrize("only,source", [("attention", "attention_kernels"),
                                         ("block", "block_kernels"),
                                         ("cache", "cache_kernels")])
def test_only_names_a_source_whose_wrappers_declare_its_entries(only, source):
    assert chip_smoke.ONLY_SOURCES[only] == source
    assert source in chip_smoke.KERNEL_SOURCES
    signatures = chip_smoke._ops_module(source)._SIGNATURES
    assert signatures and all(isinstance(v, list) for v in signatures.values())


def test_baseline_needs_only(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(["--baseline", "old/cache_kernels.cu"])
    assert exc.value.code == 2
    assert "--baseline needs --only" in capsys.readouterr().err


def test_unknown_only_is_refused():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(["--only", "gemv"])
    assert exc.value.code == 2


@pytest.mark.parametrize("argv", [[], ["--only", "block"],
                                  ["--only", "cache", "--baseline", "old/cache_kernels.cu"]])
def test_no_card_no_result(argv, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main(argv) == 2
    out = capsys.readouterr()
    assert out.out == "" and "only on a CUDA card" in out.err


def test_baseline_times_nothing_without_a_baseline_build():
    chip_smoke.BASELINE.clear()
    assert chip_smoke.baseline_ms(lambda: None, 3, "cache_kernels") is None
