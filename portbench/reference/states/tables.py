"""Bit-history state machines, generated procedurally.

(Copy of cmix_tpu/states/tables.py: the port keeps its own copy of this
format constant.)

Capability parity with the reference's state tables (a 256-state
nonstationary automaton given as a literal table in
src/states/nonstationary.cpp:3-11 and a procedural run-length automaton in
src/states/run-map.cpp:3-24).  We do NOT copy the reference's literal table;
we generate our own bounded-count automaton, which is part of THIS format's
spec (deterministic generation from integers only).

States encode discounted bit counts (n0, n1).  On observing bit b the
b-count saturates upward and the opposite count is discounted -- this is
what makes the model "nonstationary": old contradicting evidence decays
fast.  Count pairs are bounded asymmetrically (a large count is only
representable while the opposite count is small), which keeps the state
space at <= 256 while preserving long-run confidence states.
"""

import numpy as np

# Max representable count for one bit given the opposite bit's count.
# _CAP[min(opp, len-1)] = cap. Asymmetric bound like PAQ-family tables.
_CAP = [40, 10, 6, 4, 3, 3]


def _discount(n):
    """Discount the opposite count on a contradicting observation."""
    if n <= 2:
        return n
    return 2 + (n - 2) // 2


def _bounded(n0, n1):
    n0 = min(n0, _CAP[min(n1, len(_CAP) - 1)])
    n1 = min(n1, _CAP[min(n0, len(_CAP) - 1)])
    return n0, n1


def generate_nonstationary():
    """Returns (next_table[256,2] uint8, init_prob12[256] int32, n_states)."""
    # Enumerate reachable states breadth-first from (0,0).
    states = {}
    order = []

    def sid(pair):
        if pair not in states:
            states[pair] = len(order)
            order.append(pair)
        return states[pair]

    sid((0, 0))
    i = 0
    while i < len(order):
        n0, n1 = order[i]
        i += 1
        for b in (0, 1):
            if b == 0:
                nn0, nn1 = n0 + 1, _discount(n1)
            else:
                nn0, nn1 = _discount(n0), n1 + 1
            sid(_bounded(nn0, nn1))

    n = len(order)
    assert n <= 256, n
    nxt = np.zeros((256, 2), dtype=np.uint8)
    prob = np.zeros(256, dtype=np.int32)
    for (n0, n1), s in states.items():
        for b in (0, 1):
            if b == 0:
                nn0, nn1 = n0 + 1, _discount(n1)
            else:
                nn0, nn1 = _discount(n0), n1 + 1
            nxt[s, b] = states[_bounded(nn0, nn1)]
        # Krichevsky-Trofimov style init estimate in p12.
        p = (n1 + 0.4) / (n0 + n1 + 0.8)
        prob[s] = int(np.clip(round(p * 4096), 1, 4095))
    return nxt, prob, n


def generate_runmap():
    """Run-length automaton: state=(last_bit, min(run,127)).

    Parity with src/states/run-map.cpp:3-24 (procedurally built there too).
    state id = last_bit*128 + min(run-1, 127). Initial state 0 == (0, run 1).
    """
    nxt = np.zeros((256, 2), dtype=np.uint8)
    prob = np.zeros(256, dtype=np.int32)
    for s in range(256):
        last, run = s >> 7, (s & 127) + 1
        for b in (0, 1):
            if b == last:
                nrun = min(run + 1, 128)
                nxt[s, b] = (last << 7) + (nrun - 1)
            else:
                nxt[s, b] = (b << 7) + 0
        # P(1): confidence grows with run length.
        conf = run / (run + 1.0)
        p = conf if last == 1 else 1.0 - conf
        prob[s] = int(np.clip(round(p * 4096), 1, 4095))
    return nxt, prob, 256


NS_NEXT, NS_INIT_P12, NS_NUM_STATES = generate_nonstationary()
RUN_NEXT, RUN_INIT_P12, _ = generate_runmap()
