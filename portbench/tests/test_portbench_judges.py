"""Every configuration's judge holds what the harness's tests take from
it (``portbench/lookup.py``): a forward check against the program
(``check_forward``) and at least one fault its comparison must catch
(``FAULTS``), so that a configuration of a new kind skips neither."""

import types

import pytest

import tiny
from portbench import lookup


def _missing(judge) -> list:
    out = []
    if not callable(getattr(judge, "check_forward", None)):
        out.append("check_forward")
    faults = getattr(judge, "FAULTS", None)
    if not (isinstance(faults, dict) and faults
            and all(callable(f) for f in faults.values())):
        out.append("FAULTS")
    return out


@pytest.mark.parametrize("config", [c["name"] for c in
                                    tiny.bench()["configs"]])
def test_judge_has_its_duties(config):
    judge = lookup.module("judges", tiny.config(config)["judge"])
    assert _missing(judge) == [], judge.__name__


def test_a_judge_without_them_is_refused():
    assert _missing(types.SimpleNamespace()) == ["check_forward", "FAULTS"]
    assert _missing(types.SimpleNamespace(check_forward=print,
                                          FAULTS={})) == ["FAULTS"]
