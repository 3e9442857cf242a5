"""The port's leakage attacks (``core.attacks``, vectorised on tensors in
float64) against the JAX package's numpy ones on the same inputs: ``auc``
and ``advantage`` exactly, ``membership_inference`` and
``reconstruction_attack`` within 1e-9 (float64 sums in another order)."""
import numpy as np
import pytest
import torch

from repro.core import attacks as ja
from repro_torch.core import attacks as ta

TOL = 1e-9


def _scores(case):
    rng = np.random.default_rng(len(case))
    return {
        "separated": (np.array([2.0, 3.0]), np.array([0.0, 1.0])),
        "inverted": (np.array([0.0, 1.0]), np.array([2.0, 3.0])),
        "all-tied": (np.ones(50), np.ones(70)),
        "empty": (np.array([]), np.array([1.0])),
        "quantized": (rng.integers(0, 5, 40).astype(float), rng.integers(0, 5, 33).astype(float)),
        "continuous": (rng.normal(size=100), rng.normal(size=77) + 0.3),
    }[case]


@pytest.mark.parametrize("case", ["separated", "inverted", "all-tied", "empty", "quantized",
                                  "continuous"])
def test_auc_and_advantage_exact(case):
    pos, neg = _scores(case)
    want = ja.auc(pos, neg)
    assert ta.auc(pos, neg, device="cpu") == want
    assert ta.auc(torch.tensor(pos), torch.tensor(neg)) == want
    assert ta.advantage(want) == ja.advantage(want)


def _planted(rng, d=8, n_ent=40):
    """A release whose geometry encodes the member triples (e_t = e_h + r̂)."""
    ent = rng.normal(size=(n_ent, d))
    offsets = rng.normal(size=(2, d))
    members = []
    for i in range(0, 30, 2):
        r = i % 4 // 2
        ent[i + 1] = ent[i] + offsets[r] + 0.01 * rng.normal(size=d)
        members.append((i, r, i + 1))
    nonmembers = [(int(a), int(r), int(b)) for (a, b), r in
                  zip(rng.integers(30, n_ent, size=(15, 2)), rng.integers(0, 3, 15))]
    return ent, np.asarray(members, np.int64), np.asarray(nonmembers, np.int64)


@pytest.mark.parametrize("release", ["planted", "noise", "partial", "background"])
def test_membership_inference_matches_the_reference(release):
    rng = np.random.default_rng(0)
    ent, members, nonmembers = _planted(rng)
    rows = {i: ent[i] for i in range(len(ent))}
    background = None
    if release == "noise":
        rows = {i: rng.normal(size=ent.shape[1]) for i in range(len(ent))}
    elif release == "partial":  # unreleased endpoints and an unfitted relation are skipped
        rows = {i: ent[i] for i in range(len(ent)) if i % 7}
    elif release == "background":
        background = members[::2]
    want = ja.membership_inference(rows, members, nonmembers, background)
    got = ta.membership_inference(rows, members, nonmembers, background, device="cpu")
    assert got["n_member"] == want["n_member"] and got["n_nonmember"] == want["n_nonmember"]
    for k in ("auc", "advantage"):
        assert abs(got[k] - want[k]) <= TOL, (k, got, want)
    if release == "planted":
        assert got["auc"] > 0.9
    tensors = {k: torch.tensor(v) for k, v in rows.items()}
    assert ta.membership_inference(tensors, members, nonmembers, background) == got
    assert ta.membership_inference({}, members, nonmembers, device="cpu") == \
        ja.membership_inference({}, members, nonmembers)


@pytest.mark.parametrize("release", ["rotated", "noise", "scaled"])
def test_reconstruction_attack_matches_the_reference(release):
    rng = np.random.default_rng(1)
    true = rng.normal(size=(30, 6))
    q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    released = {"rotated": true @ q, "noise": rng.normal(size=(30, 6)),
                "scaled": 0.3 * true @ q + 0.1 * rng.normal(size=(30, 6))}[release]
    want = ja.reconstruction_attack(released, true)
    got = ta.reconstruction_attack(released, true, device="cpu")
    for k in ("cosine", "mse"):
        assert abs(got[k] - want[k]) <= TOL, (k, got, want)
    with pytest.raises(ValueError, match="match"):
        ta.reconstruction_attack(true[:5], true, device="cpu")
