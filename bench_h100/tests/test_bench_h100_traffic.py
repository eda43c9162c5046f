"""The traffic generators are functions of ``--seed`` alone, give every
seed the same amount of work (the same files and windows), and the
corpus's CSV reads back exactly."""

import io

import numpy as np

from conftest import SEED

from bench_h100 import corpus
from bench_h100.drivers import train_epochs


def test_sequences_are_deterministic_in_the_seed():
    a = corpus.split_sequences(SEED, 1, 400)
    b = corpus.split_sequences(SEED, 1, 400)
    c = corpus.split_sequences(SEED + 1, 1, 400)
    assert all(np.array_equal(x[3], y[3]) for x, y in zip(a, b))
    assert not np.array_equal(a[0][3], c[0][3])
    assert [x[:3] for x in a] == [x[:3] for x in c]


def test_a_subset_of_actions_draws_the_same_files():
    whole = corpus.split_sequences(SEED, 2, 400)
    one = corpus.split_sequences(SEED, 2, 400, actions=("phoning",))
    match = [x for x in whole if x[1] == "phoning"]
    assert all(np.array_equal(x[3], y[3]) for x, y in zip(one, match))


def test_csv_reads_back_exactly():
    seq = corpus.sequence(SEED, 5, 3, 1, 400)
    text = corpus.csv_bytes(seq)
    back = np.loadtxt(io.BytesIO(text), delimiter=",", dtype=np.float64)
    assert np.array_equal(back, seq)
    assert np.array_equal(back.astype(np.float32).astype(np.float64), seq)


def test_csv_reads_back_exactly_through_the_port_reader(tmp_path):
    from motionmixerconv_tpu_torch._native import read_csv_native

    seq = corpus.sequence(SEED, 1, 0, 2, 400)
    path = tmp_path / "walking_2.txt"
    path.write_bytes(corpus.csv_bytes(seq))
    got = read_csv_native(str(path))
    assert got is not None and np.array_equal(got, seq.astype(np.float32))


def test_derived_seeds_are_deterministic_and_fit_the_generators():
    # the weights', dropout's and each epoch's shuffle seeds, from --seed
    for tags in ((2,), (3,), (4, 0), (4, 17)):
        a = train_epochs._seed(SEED, *tags)
        assert a == train_epochs._seed(SEED, *tags)
        assert a != train_epochs._seed(SEED + 1, *tags)
        assert 0 <= a < 2 ** 31
