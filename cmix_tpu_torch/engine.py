"""The batched byte-tree transcoder engine, in PyTorch.

Port of cmix_tpu/engine.py.  Same ensemble, same update rules, same archive
semantics; plain tensor code batched over the B blocks of a coding group,
with the DMC apply+walk as the one hand-written CUDA kernel
(``models/dmc.py``).  Module-global gate state becomes a frozen ``Gates``
value passed to the engine; its names, defaults and ``blob`` bytes are the
JAX package's ``_GATE_SPEC``/``gates_blob``.

Two profiles, as in the JAX package (README "Determinism contract"):

* the fast profile (PORT=0) mixes in float32;
* the portable profile (PORT=1) computes everything that feeds the coder
  in int32: ``utils/intmath.py`` for stretch/squash and for every integer
  contraction, integer twins of the slot, PPM, mixer and APM updates
  (the ``*_int`` functions below) and the integer LSTM
  (``mixer/ilstm.py``).  Its archives are byte-identical to the JAX
  package's on any device.

Each profile runs every gate set the JAX package codes (``make_gates``):
the default-on components switched off alone or together (WIKI, MATCH2,
RUNX, MIX2X, APM2X, STEMX, CTX2-4, BANK_CK, PPM_EXCL/UPD/CK/DEEP,
MIX_DYN2/3, W_APM_LEARN), the value knobs (MIX_LR, CNT_CAP, MIX_NORM,
STAT_NORM, CMIX_N_IND, the order and state-bank column lists, RUNX_N,
BANK_CH, DMC_LEVELS) and any mix of them with the mechanisms below.  On
each set the runner switches on the content-routed gates
(``runner.compress``): X86X=2 (4 opcode-stream bank contexts), GRID2=1 (2
record-grid pixel contexts), JPEGX=1 (8 coefficient-plane contexts),
outside PORT LMS=2 (the strided linear predictor, one input, media blocks
only), and with a dictionary WRTW=1 (the WRT codeword tracker of
``contexts/hashes.py``; any WRTW value is accepted, and at 2 and above the
shared state carries the dictionary's ``wrtw_word``/``wrtw_stem`` tables).
``make_pretrainer`` replays a dictionary through the model at B=1 (the
runner's pretraining).

The off-by-default mechanisms run in either profile: SSE2 (a serial SSE
stage with a learned 2-weight mixer), APM3X (a bit-history-gated APM),
MIX_DYN4 and MIX_KIND (six more layer-1 gates), MIX_AUX (the LSTM/PPM/DMC
stretches fed raw into layer 2), APM_FIXED (the fixed final blend) and
JVAL (the JPEG coefficient-value model, with JPEGX); in the fast profile
only (as the JAX
package rules) VMATCH (the vertical match), SBANK_ADAPT (count-adaptive
state-bank rates), MIX_TAU (the decayed mixer rate) and MIX_BOOST (whose
per-row rates act under MIX_NORM=0).  X86X=1 and LMS=1 run through the
engine; the runner routes X86X and LMS to 0 or 2 from the content.

Determinism on the card (encode and decode must compute the same bits):

* duplicate-index set-scatters (two blocks writing one shared table row)
  resolve by an explicit rule -- every duplicate carries the value of the
  highest block index, the JAX package's ``_claim_win`` rule and XLA-CPU's
  last-in-order winner -- so the write order never matters;
* float scatter-adds use ``index_add_``, which runs a sorted segment sum
  on CUDA once ``torch.use_deterministic_algorithms(True)`` is set (done by
  ``resolve_device`` for every CUDA run, with CUBLAS_WORKSPACE_CONFIG);
  integer scatter-adds are exact in any order;
* float cumulative sums are float32 adds in a fixed order (``utils/ops.py``);
* deterministic mode's fill of every new allocation is switched off: each
  operator of the step writes its whole output.
"""

import contextlib
import dataclasses
import os
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from cmix_tpu_torch.contexts.hashes import (
    MAX_ORDER, WRTW_TAB_N, init_ctx_state, update_ctx_state_batched,
    bracket_ctx, line_expected)
from cmix_tpu_torch.contexts.x86 import (
    init_x86_state, x86_update, x86_ctx_vals, x86_ext_vals, x86_ext_vals2)
from cmix_tpu_torch.mixer.ilstm import (
    ILstmConfig, init_ilstm_shared, init_ilstm_perblock,
    ilstm_shared_byte_update)
from cmix_tpu_torch.mixer.lstm import (
    LstmConfig, init_lstm_shared, init_lstm_perblock,
    lstm_shared_byte_update)
from cmix_tpu_torch.models import dmc
from cmix_tpu_torch.states.tables import (
    NS_NEXT, NS_INIT_P12, RUN_NEXT, RUN_INIT_P12)
from cmix_tpu_torch.u32 import M32, PRIME2, mix32, mul, to_bits
from cmix_tpu_torch.utils.intmath import (
    ieinsum, squash12_lut, squash16_lut, stretch13_lut)
from cmix_tpu_torch.utils.ops import cumprod_last, cumsum0_last

MODE_ENCODE = 0
MODE_DECODE = 1


class FormatError(ValueError):
    """Archive cannot be decoded by this build/configuration."""


# ---- format gates (copy of cmix_tpu/engine.py _GATE_SPEC) ----------------
_GATE_SPEC = (
    ("CMIX_N_IND", int, "8"),
    ("WIKI", int, "1"),
    ("X86X", int, "0"),
    ("CMIX_MATCH_ORDERS", str, "1,2,3,5,8,12,16,24,100,101"),
    ("MATCH2", int, "1"),
    ("CMIX_PPM_ORDERS", str, "1,2,3,4,5,6,8,10,12,16,20,24"),
    ("PPM_EXCL", int, "1"),
    ("PPM_UPD", int, "1"),
    ("PPM_CK", int, "1"),
    ("PPM_DEEP", int, "1"),
    ("BANK_CK", int, "2"),
    ("MIX_DYN3", int, "1"),
    ("MIX_DYN4", int, "0"),
    ("CMIX_SBANK_COLS", str, "0,1,2,3,5,7,10,14,24,36"),
    ("SBANK_ADAPT", int, "0"),
    ("VMATCH", int, "0"),
    ("LMS", int, "0"),
    ("GRID2", int, "0"),
    ("JVAL", int, "0"),
    ("JPEGX", int, "0"),
    ("STEMX", int, "1"),
    ("WRTW", int, "0"),
    ("CTX2", int, "1"),
    ("CTX3", int, "1"),
    ("CTX4", int, "1"),
    ("BANK_CH", int, "3"),
    ("RUNX", int, "1"),
    ("RUNX_N", int, "64"),
    ("MIX_DYN2", int, "1"),
    ("MIX2X", int, "1"),
    ("MIX_KIND", int, "0"),
    ("MIX_AUX", int, "0"),
    ("MIX_LR", float, "4e-3"),
    ("MIX_TAU", float, "0"),
    ("MIX_BOOST", float, "0"),
    ("MIX_BOOST_N", float, "256"),
    ("W_APM_LEARN", int, "1"),
    ("MIX_NORM", int, "1"),
    ("STAT_NORM", int, "1"),
    ("APM2X", int, "1"),
    ("APM_FIXED", int, "0"),
    ("APM3X", int, "0"),
    ("SSE2", int, "0"),
    ("CNT_CAP", int, "60"),
    ("DMC_LEVELS", int, "8"),
    ("PORT", int, "0"),
    ("ILSTM_LRX", int, "4"),
    ("ILSTM_ADAM", int, "0"),
)
# the bench speed profile (bench.py:65-69)
BENCH_GATES = {"DMC_LEVELS": 7, "PPM_CK": 0, "PPM_DEEP": 0, "BANK_CH": 1,
               "CTX4": 0}
# float-internal paths the portable profile excludes (JAX engine _derive)
_NOT_WITH_PORT = ("VMATCH", "LMS", "MIX_TAU", "MIX_BOOST")
# gates the JAX package counts into a width (N_BANK, N_INPUTS, N_APM) at
# their value but whose code adds one block when they are on: only these
# values give the widths the code builds, others fail its trace (X86X's
# values are _derive's own check; CMIX_N_IND's 0 and past 8 fail there too)
_COUNTED = {"WIKI": (0, 1), "GRID2": (0, 1), "JPEGX": (0, 1), "STEMX": (0, 1),
            "CTX2": (0, 1), "CTX3": (0, 1), "CTX4": (0, 1), "MATCH2": (0, 1),
            "VMATCH": (0, 1), "APM2X": (0, 1), "APM3X": (0, 1),
            "X86X": (0, 1, 2), "JVAL": (0, 1, 2), "BANK_CH": (1, 2, 3),
            "CMIX_N_IND": tuple(range(1, 9))}


def _norm_gate(name, typ, raw):
    if typ is int:
        v = int(raw)
        if name == "CNT_CAP":
            v = max(1, min(v, 63))
        return str(v)
    if typ is float:
        return repr(float(raw))
    return str(raw)


GATE_NAMES = tuple(n for n, _, _ in _GATE_SPEC)
_DEFAULTS = {n: _norm_gate(n, t, d) for n, t, d in _GATE_SPEC}


def _int_gate(name):
    """A property: the gate ``name`` as an int."""
    return cached_property(lambda self: int(self[name]))


def _list_gate(name):
    """A property: the comma-separated gate ``name`` as a tuple of ints."""
    return cached_property(
        lambda self: tuple(int(o) for o in self[name].split(",")))


@dataclass(frozen=True)
class Gates:
    """One validated gate set (normalized name -> value strings).  Every
    gate of ``_GATE_SPEC`` is a property (an int, a float, a bool for PORT
    and ILSTM_ADAM, a tuple of ints for the order and column lists); the
    derived sizes follow cmix_tpu/engine.py _derive."""
    env: tuple

    def __getitem__(self, name):
        return dict(self.env)[name]

    def blob(self) -> bytes:
        """Canonical non-default gate record for the archive header."""
        return ";".join(f"{n}={v}" for n, v in self.env
                        if v != _DEFAULTS[n]).encode("ascii")

    n_ind = _int_gate("CMIX_N_IND")
    wiki = _int_gate("WIKI")
    x86x = _int_gate("X86X")
    match_orders = _list_gate("CMIX_MATCH_ORDERS")
    match2 = _int_gate("MATCH2")
    ppm_excl = _int_gate("PPM_EXCL")
    ppm_upd = _int_gate("PPM_UPD")
    ppm_ck = _int_gate("PPM_CK")
    ppm_deep = _int_gate("PPM_DEEP")
    bank_ck = _int_gate("BANK_CK")
    mix_dyn3 = _int_gate("MIX_DYN3")
    mix_dyn4 = _int_gate("MIX_DYN4")
    sbank_cols = _list_gate("CMIX_SBANK_COLS")
    sbank_adapt = _int_gate("SBANK_ADAPT")
    vmatch = _int_gate("VMATCH")
    lms = _int_gate("LMS")
    grid2 = _int_gate("GRID2")
    jval = _int_gate("JVAL")
    jpegx = _int_gate("JPEGX")
    stemx = _int_gate("STEMX")
    wrtw = _int_gate("WRTW")
    ctx2 = _int_gate("CTX2")
    ctx3 = _int_gate("CTX3")
    ctx4 = _int_gate("CTX4")
    bank_ch = _int_gate("BANK_CH")
    runx = _int_gate("RUNX")
    mix_dyn2 = _int_gate("MIX_DYN2")
    mix2x = _int_gate("MIX2X")
    mix_kind = _int_gate("MIX_KIND")
    mix_aux = _int_gate("MIX_AUX")
    w_apm_learn = _int_gate("W_APM_LEARN")
    mix_norm = _int_gate("MIX_NORM")
    stat_norm = _int_gate("STAT_NORM")
    apm2x = _int_gate("APM2X")
    apm_fixed = _int_gate("APM_FIXED")
    apm3x = _int_gate("APM3X")
    sse2 = _int_gate("SSE2")
    cnt_cap = _int_gate("CNT_CAP")
    ilstm_lrx = _int_gate("ILSTM_LRX")

    @cached_property
    def port(self):
        return int(self["PORT"]) != 0

    @cached_property
    def ilstm_adam(self):
        return int(self["ILSTM_ADAM"]) != 0

    @cached_property
    def dmc_levels(self):
        return min(int(self["DMC_LEVELS"]), 8)

    @cached_property
    def mix_lr(self):
        return float(self["MIX_LR"])

    @cached_property
    def mix_tau(self):
        return float(self["MIX_TAU"])

    @cached_property
    def mix_boost(self):
        return float(self["MIX_BOOST"])

    @cached_property
    def mix_boost_n(self):
        return float(self["MIX_BOOST_N"])

    # ---- derived sizes (cmix_tpu/engine.py _derive)
    @cached_property
    def n_bank(self):
        return (47 + self.n_ind + 4 * self.wiki + 2 * self.x86x
                + 2 * self.grid2 + 8 * self.jpegx + 2 * self.stemx
                + 8 * self.ctx2 + 8 * self.ctx3 + 8 * self.ctx4)

    @cached_property
    def n_match(self):
        return len(self.match_orders)

    @cached_property
    def mstride(self):
        # MATCH2 keeps the two latest positions per match-table key
        return 1 + self.match2

    @cached_property
    def ppm_orders(self):
        o = tuple(int(x) for x in self["CMIX_PPM_ORDERS"].split(","))
        return o + ((32, 48) if self.ppm_deep else ())

    @cached_property
    def n_ppm(self):
        return len(self.ppm_orders)

    @cached_property
    def n_sbank(self):
        return len(self.sbank_cols)

    @cached_property
    def sbank_gate(self):
        # the state-bank model whose root state gates MIX2X, APM3X and SSE2:
        # the order-2 one (column 1), else the first
        return self.sbank_cols.index(1) if 1 in self.sbank_cols else 0

    @cached_property
    def runx_n(self):
        return min(int(self["RUNX_N"]), self.n_bank, 64)

    @cached_property
    def dmc_idx(self):
        return self.n_bank + 4 + self.n_match + 2 + self.n_sbank

    @cached_property
    def n_primary(self):
        # bank + d0/d12 + match + lstm + ppm + sbank + dmc + lms + vmatch
        # + match2 + runx + jval (one channel per JVAL tier)
        return (self.n_bank + 4 + self.n_match + 1 + 1 + self.n_sbank + 1
                + (1 if self.lms else 0) + self.vmatch
                + self.match2 * self.n_match
                + (self.runx_n if self.runx else 0) + self.jval)

    @cached_property
    def n_inputs(self):
        return self.n_primary + (self.bank_ch - 1) * self.n_bank

    @cached_property
    def mix1_rows(self):
        return np.array([1, 8, 256, 1024, 64, 256, 256, 64, 512, 128, 64]
                        + ([257, 256, 64, 256] if self.mix_dyn2 else [])
                        + ([2048, 257, 32, 256, 256] if self.mix_dyn3
                           else [])
                        + ([32, 256, 64, 256, 272] if self.mix_dyn4 else [])
                        + ([64] if self.mix_kind else []), dtype=np.int64)

    @cached_property
    def n_mix1(self):
        return len(self.mix1_rows)

    @cached_property
    def mix1_off(self):
        return np.concatenate([[0], np.cumsum(self.mix1_rows)[:-1]])

    @cached_property
    def mix1_total(self):
        return int(self.mix1_rows.sum())

    @cached_property
    def m2in(self):
        # layer-2 inputs: the layer-1 outputs, then MIX_AUX's raw taps
        return self.n_mix1 + (3 if self.mix_aux else 0)

    @cached_property
    def aux_taps(self):
        # the input channels of the LSTM, PPM and DMC stretches (MIX_DYN4's
        # average, MIX_AUX's taps)
        lstm = self.n_bank + 4 + self.n_match
        return (lstm, lstm + 1, self.dmc_idx)

    @cached_property
    def mix2_rows(self):
        return np.array([64, 64, 256, 256, 256] if self.mix2x else [],
                        dtype=np.int64)

    @cached_property
    def mix2_off(self):
        return np.concatenate([[0], np.cumsum(self.mix2_rows)[:-1]]
                              ).astype(np.int64)[:len(self.mix2_rows)]

    @cached_property
    def mix2_total(self):
        return int(self.mix2_rows.sum())

    @cached_property
    def n_l2(self):
        return 3 + len(self.mix2_rows)

    @cached_property
    def sbank_kind(self):
        return tuple(1 if c == 14 else 0 for c in self.sbank_cols)

    @cached_property
    def sbank_next(self):
        return np.stack([RUN_NEXT if k else NS_NEXT
                         for k in self.sbank_kind])     # (NS, 256, 2) u8

    @cached_property
    def sbank_p0(self):
        return np.stack([(RUN_INIT_P12 if k else NS_INIT_P12
                          ).astype(np.float32) / 4096.0
                         for k in self.sbank_kind])     # (NS, 256)

    @cached_property
    def n_apm(self):
        # the parallel APMs: byte, match, order-2, APM2X's word and line,
        # APM3X's bit-history stage
        return 3 + 2 * self.apm2x + self.apm3x

    @cached_property
    def sse2_base(self):
        # [0,576) the first three | 512 rows of APM2X's two | 256 rows of
        # APM3X | then the SSE2 stage's rows
        return 576 + 512 * self.apm2x + 256 * self.apm3x

    @cached_property
    def apm_rows(self):
        return self.sse2_base + 256 * self.sse2


def make_gates(env=None) -> Gates:
    """Validate a gate mapping (name -> raw value; missing = default).

    Accepts every gate set the JAX package codes.  Raises FormatError where
    the JAX package's ``_derive`` does (an unknown gate or value, an X86X
    it does not know, PORT with a float-internal path) and where it accepts
    a set that its byte step cannot trace, so that no archive carries it
    (ROADMAP.md's reference faults): PORT with SBANK_ADAPT, JVAL without
    JPEGX, a width-counted gate outside the values its code builds
    (``_COUNTED``), a PPM order past the order hashes without PPM_DEEP or
    a negative one, RUNX with a negative RUNX_N.  It also refuses APM2X=-1
    and a negative SSE2, which the JAX package traces with APM rows past
    its APM table (its reads clamp onto other rows, its writes drop)."""
    env = dict(env or {})
    for name in env:
        if name not in _DEFAULTS:
            raise FormatError(f"unknown model gate {name!r}")
    try:
        vals = {n: _norm_gate(n, t, env.get(n, d)) for n, t, d in _GATE_SPEC}
        g = Gates(tuple((n, vals[n]) for n, _, _ in _GATE_SPEC))
        _ = (g.match_orders, g.ppm_orders, g.sbank_cols)   # the lists parse
    except ValueError as e:
        raise FormatError(f"malformed gate value: {e}") from None
    if g.x86x not in (0, 1, 2):
        raise FormatError(f"X86X={g.x86x} unsupported (expected 0, 1, 2)")
    if g.port and any(vals[n] != _DEFAULTS[n] for n in _NOT_WITH_PORT):
        raise FormatError("PORT=1 requires VMATCH=0, LMS=0, MIX_TAU=0 "
                          "and MIX_BOOST=0 (float-internal paths)")
    if g.port and g.sbank_adapt:
        raise FormatError("PORT=1 with SBANK_ADAPT cannot be coded: the JAX "
                          "package keeps its visit counts in float32 and its "
                          "integer rate shift fails, so no archive has it")
    if g.jval and not g.jpegx:
        raise FormatError("JVAL requires JPEGX: its contexts are the JPEG "
                          "coefficient coordinates (the runner routes it "
                          "with JPEGX)")
    for name, ok in _COUNTED.items():
        if int(vals[name]) not in ok:
            raise FormatError(
                f"{name}={vals[name]} cannot be coded: the JAX package "
                f"counts it into a model width, and its code builds that "
                f"width only at {ok}")
    bad = [o for o in g.ppm_orders
           if o < 0 or (o > MAX_ORDER and not g.ppm_deep)]
    if bad:
        raise FormatError(f"CMIX_PPM_ORDERS {bad}: orders past "
                          f"{MAX_ORDER} read the deep window hashes, which "
                          "exist only under PPM_DEEP, and a negative order "
                          "has no salt")
    if g.runx and int(vals["RUNX_N"]) < 0:
        raise FormatError(f"RUNX_N={vals['RUNX_N']}: RUNX needs a "
                          "non-negative count")
    if g.sse2 < 0:
        raise FormatError(f"SSE2={g.sse2}: the SSE2 rows would lie past the "
                          "APM table")
    return g


def gates_from_blob(blob: bytes) -> Gates:
    """The gate set an archive's gate record pins."""
    env = {}
    for item in blob.decode("ascii").split(";") if blob else []:
        if not item:
            continue
        name, _, val = item.partition("=")
        if name not in _DEFAULTS:
            raise FormatError(
                f"archive uses unknown model gate {name!r}; "
                "it was written by a newer tpu-cmix build")
        env[name] = val
    return make_gates(env)


DEFAULT_GATES = make_gates()

# ---- format constants (cmix_tpu/engine.py)
D12_BRK = 256 + 65536
D12_ROWS = D12_BRK + 512
SBANK_RATE = 0.02
SEE_DIST_B = 16
SEE_TOT_B = 8
SEE_RATE = 0.02
ST_CLAMP = 12.0
SLOT_INIT = (4096 << 18) | (2048 << 6)
HDR_INIT = 256 << 16
APM_RATE = 0.02
# JVAL: zigzag position -> band bucket (the low bands get rows of their
# own, the high-frequency tail shares); the rows per tier (copies of
# cmix_tpu/engine.py _JBAND, JVAL_ROWS, JVAL2_ROWS)
_JBAND = np.concatenate([
    np.arange(6), np.full(4, 6), np.full(6, 7), np.full(12, 8),
    np.full(36, 9)]).astype(np.int64)     # (64,)
JVAL_ROWS = 4 * 10 * 8 * 8                # comp x band x magN x magW
JVAL2_ROWS = 4 * 64                       # comp x zigzag position
POS_BITS = 24
PPM_INC = 3
LMS_K = 4
LMS_MU = 0.002
PRETRAIN_SEG = 4096        # pretraining's segment (min'd with the block):
#                            sets the dictionary stream's padding

_NODE = np.arange(256)
_LEVEL = np.zeros(256, dtype=np.int64)
for _n in range(1, 256):
    _LEVEL[_n] = _n.bit_length() - 1
_SPAN = (256 >> _LEVEL.clip(0, 8)).astype(np.int64)
_LO = ((_NODE - (1 << _LEVEL)) * _SPAN).astype(np.int64)
_LO[0] = 0
_MID = _LO + (_SPAN >> 1)
_HI = _LO + _SPAN
_LVL_ONEHOT = (np.arange(8)[:, None] == _LEVEL[None, :]).astype(np.float32)
_IS_VOWEL = np.zeros(256, np.int64)
for _c in b"aeiouAEIOU":
    _IS_VOWEL[_c] = 1


@dataclass(frozen=True)
class EngineConfig:
    block_size: int = 1 << 16
    tbits: int = 20
    mbits: int = 20
    ibits: int = 16
    pbits: int = 20
    lstm_hidden: int = 256
    lstm_layers: int = 2
    lstm_horizon: int = 8
    dmc_nodes: int = 16384
    seg_size: int = 4096

    def __post_init__(self):
        object.__setattr__(self, "seg_size",
                           min(self.seg_size, self.block_size))
        for name in ("block_size", "seg_size"):
            v = getattr(self, name)
            if v <= 0 or v & (v - 1):
                raise FormatError(f"{name}={v} must be a power of two "
                                  "(the archive header stores its log2)")
        if self.block_size % self.seg_size:
            raise FormatError("block_size must be a multiple of seg_size")
        if self.block_size > (1 << POS_BITS):
            raise FormatError(
                f"block_size {self.block_size} exceeds the match-table "
                f"position width (2^{POS_BITS})")
        if self.dmc_nodes > 65536:
            raise FormatError(f"dmc_nodes={self.dmc_nodes} exceeds 65536")
        if self.dmc_nodes and self.dmc_nodes < dmc.N_BASE + 2:
            raise FormatError(
                f"dmc_nodes={self.dmc_nodes} is below the base braid "
                f"({dmc.N_BASE + 2}); use 0 to disable DMC")

    @property
    def rows(self):
        return 1 << max(0, self.tbits - 8)

    @property
    def prows(self):
        return 1 << max(0, self.pbits - 8)

    @property
    def comp_size(self):
        return self.block_size + self.block_size // 2 + 64

    @property
    def seg_cap(self):
        return 2 * self.seg_size + 64


def resolve_device(device="cuda"):
    """The torch.device an entry point runs on.

    "cuda" (the default) requires a GPU and switches on deterministic
    algorithms (the format's contract on the card); "cpu" is explicit."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cmix_tpu_torch: no CUDA device; pass device='cpu' "
                "(--device cpu) to run on the CPU")
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        # every operator of the step writes all of its output, so the
        # NaN/max-int fill of each new allocation that deterministic mode
        # adds by default is pure cost (one kernel per allocation)
        torch.utils.deterministic.fill_uninitialized_memory = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _lstm_cfg(cfg: EngineConfig, g: Gates):
    """The LSTM of the profile: the integer re-spec under PORT (one layer;
    ILSTM_LRX scales its rates by x/4), else the float LSTM."""
    if g.port:
        x = g.ilstm_lrx
        return ILstmConfig(hidden=cfg.lstm_hidden, horizon=cfg.lstm_horizon,
                           lr_wx=192 * x // 4, lr_wh=96 * x // 4,
                           lr_wo=96 * x // 4, lr_b=48 * x // 4,
                           adam=g.ilstm_adam,
                           alr_wx=40 * x // 4, alr_wh=20 * x // 4,
                           alr_wo=20 * x // 4, alr_b=10 * x // 4)
    return LstmConfig(hidden=cfg.lstm_hidden, layers=cfg.lstm_layers,
                      horizon=cfg.lstm_horizon)


# ------------------------------------------------------------------- state


def _st13_np(p):
    st = np.clip(np.log(p / (1.0 - p)), -ST_CLAMP, ST_CLAMP)
    return np.clip(st * 256.0 + 4096.0, 0, 8191).astype(np.uint32)


def _see_init(g):
    d = np.arange(SEE_DIST_B, dtype=np.float32)[:, None]
    tot = 1.5 * np.exp2(np.arange(SEE_TOT_B, dtype=np.float32))[None, :]
    est = np.clip(np.maximum(d, 0.5) / (np.maximum(d, 0.5) + tot),
                  0.02, 0.95).astype(np.float32)
    return np.tile(est[None], (g.n_ppm, 1, 1))


def _w2_init_row(g):
    """Layer 2 starts as the layer-1 outputs' mean; MIX_AUX's taps at 0."""
    return np.concatenate([np.full(g.n_mix1, 1.0 / g.n_mix1, np.float32),
                           np.zeros(g.m2in - g.n_mix1, np.float32)])


def _apm_row():
    stv = (np.arange(33) - 16) * 0.5
    return (1.0 / (1.0 + np.exp(-stv))).astype(np.float32)


def init_shared(cfg: EngineConfig, g: Gates, device, wrtw_tables=None):
    """Shared (per coding group) learned state -- no batch dimension.
    u32 tables are int32 tensors holding the bits; the bank is one
    (N_BANK, rows, 256) table (the JAX package splits it in <=64-bank
    chunks for a TPU runtime limit).  At WRTW >= 2 it holds the codeword
    tables ``wrtw_tables`` (``hashes.build_wrtw_tables`` of the
    dictionary; zeros without one) as int64 u32 values."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    n_pri = g.n_primary
    w1_row = np.concatenate([np.full(n_pri, 1.0 / n_pri, np.float32),
                             np.zeros(g.n_inputs - n_pri, np.float32)])
    w2_row = _w2_init_row(g)
    row0 = np.full(256, SLOT_INIT, dtype=np.int32)
    row0[0] = HDR_INIT
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    sh = {
        "d0_p": torch.full((256,), 0.5, **f32),
        "d0_c": torch.zeros(256, **f32),
        "d12": torch.full((D12_ROWS, 256), SLOT_INIT, **i32),
        # the match tables (MATCH2: two positions per key) and the
        # indirect table in one arena
        "aux_tbl": torch.zeros(g.mstride * g.n_match * (1 << cfg.mbits)
                               + g.n_ind * (1 << cfg.ibits), **i32),
        "match_conf": torch.full((g.n_match, 32), 0.55, **f32),
        "vmatch_conf": torch.full((32,), 0.55, **f32),
        "lms_conf": torch.full((16,), 0.55, **f32),
        "ppm": torch.zeros((g.n_ppm, cfg.prows, 64), **i32),
        "ppm_see": t(_see_init(g)),
        "sbank": t(np.broadcast_to(
            (_st13_np(g.sbank_p0[:, 0]) << np.uint32(8)).astype(np.int32)
            [:, None, None], (g.n_sbank, cfg.rows, 256))),
        "sbank_p": t(g.sbank_p0),
        "w1": t(np.tile(w1_row[None], (g.mix1_total, 1))),
        "w1_cnt": torch.zeros(g.mix1_total, **f32),
        "bias1": torch.zeros((g.n_mix1, 256), **f32),
        "w2": t(np.tile(w2_row[None], (8, 1))),
        "w2b": t(np.tile(w2_row[None], (256, 1))),
        "w2c": t(np.tile(w2_row[None], (64, 1))),
        "bias2": torch.zeros((g.n_l2, 256), **f32),
        "w3": torch.full((8, g.n_l2), 1.0 / g.n_l2, **f32),
        "bias3": torch.zeros(256, **f32),
        "apm": t(np.tile(_apm_row()[None], (g.apm_rows, 1))),
        "w_apm": t(np.tile(np.concatenate(
            [[0.4], np.full(g.n_apm, 0.6 / g.n_apm)]).astype(np.float32)
            [None], (64, 1))),
        "vocab_force": torch.zeros(256, dtype=torch.int64, device=device),
        "bank": t(np.broadcast_to(row0[None, None],
                                  (g.n_bank, cfg.rows, 256))),
    }
    if g.ppm_ck:
        sh["ppm_ck"] = torch.full((g.n_ppm, cfg.prows), 256, **i32)
    if g.mix2x:
        sh["w2x"] = t(np.tile(w2_row[None], (g.mix2_total, 1)))
    if g.match2:
        sh["match2_conf"] = torch.full((g.n_match, 32), 0.55, **f32)
    if g.runx:
        sh["runx_conf"] = torch.full((g.runx_n, 32), 0.55, **f32)
    # JVAL's byte counts per (component, band, magN, magW) and, at JVAL=2,
    # per (component, zigzag position)
    if g.jval:
        sh["jval"] = torch.zeros((JVAL_ROWS, 256), dtype=torch.uint8,
                                 device=device)
    if g.jval >= 2:
        sh["jval2"] = torch.zeros((JVAL2_ROWS, 256), dtype=torch.uint8,
                                  device=device)
    # the SSE2 stage's 2-weight mixer (input, stage output): the identity
    if g.sse2:
        sh["w_sse"] = t(np.tile(np.float32([[1.0, 0.0]]), (256, 1)))
    # SBANK_ADAPT's visits per (model, state), float32 as in the JAX package
    if g.sbank_adapt:
        sh["sbank_c"] = torch.zeros((g.n_sbank, 256), **f32)
    if g.port:
        sh.update(_port_tables(g, device))
        del sh["vmatch_conf"], sh["lms_conf"], sh["w1_cnt"]
    if cfg.lstm_hidden:
        lcfg = _lstm_cfg(cfg, g)
        sh["lstm"] = (init_ilstm_shared(lcfg, device) if g.port else
                      init_lstm_shared(lcfg, device))
    if g.wrtw >= 2:
        for key, tab in zip(("wrtw_word", "wrtw_stem"), wrtw_tables or (
                np.zeros(WRTW_TAB_N, np.uint32),) * 2):
            sh[key] = torch.as_tensor(np.asarray(tab, np.int64),
                                      device=device)
    return sh


def _port_tables(g: Gates, device):
    """The portable profile's integer domains for the float-valued tables
    (same keys): probabilities as p12, mixer weights at a 16-bit fraction,
    biases in st256 at a 16-bit fraction (JAX engine init_shared)."""
    def q(a, scale, lo=None, hi=None):
        v = np.round(a * np.float32(scale))
        return (v if lo is None else np.clip(v, lo, hi)).astype(np.int32)

    n_pri = g.n_primary
    w1 = q(np.concatenate([np.full(n_pri, 1.0 / n_pri, np.float32),
                           np.zeros(g.n_inputs - n_pri, np.float32)]),
           65536)
    w2 = q(_w2_init_row(g), 65536)
    tile = lambda row, n: torch.as_tensor(                       # noqa
        np.ascontiguousarray(np.tile(row[None], (n, 1))), device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "d0_p": torch.full((256,), 2048, **i32),
        "d0_c": torch.zeros(256, **i32),
        "match_conf": torch.full((g.n_match, 32), 2253, **i32),
        **({"match2_conf": torch.full((g.n_match, 32), 2253, **i32)}
           if g.match2 else {}),
        **({"runx_conf": torch.full((g.runx_n, 32), 2253, **i32)}
           if g.runx else {}),
        "ppm_see": torch.as_tensor(q(_see_init(g), 4096, 4, 3891),
                                   device=device),
        "sbank_p": torch.as_tensor(q(g.sbank_p0, 4096, 1, 4095),
                                   device=device),
        "w1": tile(w1, g.mix1_total),
        "bias1": torch.zeros((g.n_mix1, 256), **i32),
        "w2": tile(w2, 8),
        "w2b": tile(w2, 256),
        "w2c": tile(w2, 64),
        **({"w2x": tile(w2, g.mix2_total)} if g.mix2x else {}),
        "bias2": torch.zeros((g.n_l2, 256), **i32),
        "w3": torch.full((8, g.n_l2), 65536 // g.n_l2, **i32),
        "bias3": torch.zeros(256, **i32),
        "apm": tile(q(_apm_row(), 4096, 1, 4095), g.apm_rows),
        "w_apm": tile(np.array([26214] + [(65536 * 6 // 10) // g.n_apm]
                               * g.n_apm, np.int32), 64),
        **({"w_sse": tile(np.int32([65536, 0]), 256)} if g.sse2 else {}),
    }


def init_perblock(cfg: EngineConfig, g: Gates, B, device):
    """Per-block positional state, batched over B blocks."""
    i64 = dict(dtype=torch.int64, device=device)
    nm = g.n_match
    pb = {
        "ctx": init_ctx_state(B, device),
        "ind_val": torch.zeros((B, g.n_ind), **i64),
        "hist": torch.zeros((B, cfg.block_size), dtype=torch.uint8,
                            device=device),
        "mp_blk": torch.zeros((B, nm), **i64),
        "mp_pos": torch.zeros((B, nm), **i64),
        "match_len": torch.zeros((B, nm), **i64),
        "rec_lastpos": torch.full((B, 256), -1, **i64),
        "rec_stride": torch.zeros((B, 256), **i64),
        "rec_len": torch.ones(B, **i64),
        "rec_cnt": torch.zeros(B, **i64),
        "rec_forced": torch.zeros(B, **i64),
        "blk_kind": torch.zeros(B, **i64),
        "jpeg_rel0": torch.full((B,), -(1 << 31) + 1, **i64),
        "jpeg_clen": torch.zeros((B, 4), **i64),
        "lms_w": torch.tensor([1.0, 0.0, 0.0, 0.0], device=device
                              ).repeat(B, 1),
        "lms_err": torch.zeros(B, dtype=torch.float32, device=device),
        "x86": init_x86_state(B, device),
    }
    if g.match2:
        for k in ("mp2_blk", "mp2_pos", "match2_len"):
            pb[k] = torch.zeros((B, nm), **i64)
    if g.ppm_deep:
        pb["h32"] = torch.zeros(B, **i64)
        pb["h48"] = torch.zeros(B, **i64)
    if cfg.lstm_hidden:
        pb["lstm"] = (init_ilstm_perblock if g.port else init_lstm_perblock)(
            _lstm_cfg(cfg, g), B, device)
    if cfg.dmc_nodes:
        pb.update(dmc.init_dmc_perblock(cfg.dmc_nodes, B, device))
    return pb


def init_coder(B, device):
    z = torch.zeros(B, dtype=torch.int64, device=device)
    return {"x1": z, "x2": torch.full_like(z, M32), "xc": z.clone(),
            "total": z.clone(), "rptr": z.clone()}


# --------------------------------------------------------------- constants


class _Consts:
    """Per-(gate set, device) constant tensors of the byte step."""

    def __init__(self, g: Gates, device):
        t = lambda a, dt=torch.int64: torch.as_tensor(
            np.ascontiguousarray(a), dtype=dt, device=device)
        self.node = t(_NODE)
        self.level = t(_LEVEL)
        self.lo, self.mid, self.hi = t(_LO), t(_MID), t(_HI)
        self.lvl_onehot = t(_LVL_ONEHOT, torch.float32)
        self.lvl_i = t(_LVL_ONEHOT, torch.int32)
        self.is_vowel = t(_IS_VOWEL)
        self.mix1_off = t(g.mix1_off[2:])
        self.mix2_off = t(g.mix2_off)
        self.bank_salt = t([(m * PRIME2) & M32 for m in range(g.n_bank)])
        self.ssalt = t([((s + 7) * 0x27D4EB2F) & M32
                        for s in range(g.n_sbank)])
        self.psalt = t([(o * 0xB5297A4D) & M32 for o in g.ppm_orders])
        # a column past the bank reads as the JAX package's gather reads
        # it: negative columns count from the end, then clamp
        nb = g.n_bank
        self.scols = t([min(max(c + nb if c < 0 else c, 0), nb - 1)
                        for c in g.sbank_cols])
        nx = g.sbank_next.astype(np.int64)
        self.snext01 = t(nx[:, :, 0] | (nx[:, :, 1] << 8))    # (NS, 256)
        n_pri = g.n_primary
        self.ch_scale = t(np.concatenate(
            [np.ones(n_pri), np.full(g.n_inputs - n_pri, 0.25)]),
            torch.float32)
        self.j33 = torch.arange(33, device=device)
        self.ar16 = torch.arange(16, device=device)
        self.lms_k = torch.arange(1, LMS_K + 1, device=device)
        # JPEGX's coefficient magnitude buckets: |v - 128| >= each bound
        self.magq_bounds = t([1, 2, 4, 8, 16, 32, 64])
        self.k8 = torch.arange(8, device=device)
        self.ar32 = torch.arange(32, device=device)
        self.jband = t(_JBAND)
        self.aux_taps = t(g.aux_taps)


def _stretch_f(p):
    p = torch.clamp(p, 1e-6, 1.0 - 1e-6)
    return torch.clamp(torch.log(p / (1.0 - p)), -ST_CLAMP, ST_CLAMP)


def _st256(p12):
    """Integer stretch in st256 units (st13 - 4096) of p12 values."""
    return stretch13_lut(p12) - 4096


def _packed_st256(words, shift):
    """The stretch field (st13, from bit ``shift`` up) of packed u32 slot
    words held as int32 bits, logical shift, in st256 units."""
    return ((words >> shift) & ((1 << (32 - shift)) - 1)) - 4096


def _vote(alive, bit, st):
    """A predicted byte's vote on its tree path: +-st (per model) at the
    nodes it is alive on, 0 elsewhere (f32 or st256 int32)."""
    sign = torch.where(bit == 1, 1, -1).to(st.dtype)
    return torch.where(alive, sign * st[:, :, None], torch.zeros_like(
        st[:, :, None]))


def _apm_pos(port, st):
    """Where a stretch reads the 33-entry APM rows: (tl, frac), 7-bit
    integer weights over st256 under PORT, float32 otherwise."""
    if port:
        tq = torch.clamp(st + 2048, 0, 4095)
        tl = torch.clamp(tq >> 7, max=31).long()
        return tl, tq - (tl.to(torch.int32) << 7)            # 0..127
    tf = torch.clamp((st + 8.0) * 2.0, 0.0, 31.999)
    tl = tf.long()
    return tl, tf - tl.float()


def _apm_read(port, rows, tl, frac):
    """APM rows (B, 33) interpolated at (tl, frac): p12, or f32."""
    lo, hi = torch.gather(rows, 1, tl), torch.gather(rows, 1, tl + 1)
    if port:
        return torch.clamp((lo * (128 - frac) + hi * frac) >> 7, 1, 4095)
    return lo * (1 - frac) + hi * frac


def _take_cols(tbl, col):
    """``tbl[m, col[:, m]]`` for a (M, C) table and (B, M) columns."""
    return tbl[torch.arange(tbl.shape[0], device=tbl.device)[None, :], col]


def _idot(eq, w, x):
    """Integer mixer dot in st256 units: (sum w*x) >> 16 for 16-bit-
    fraction weights, split hi/lo as the JAX package's _idot does."""
    w_hi = w >> 8
    w_lo = w - (w_hi << 8)
    return (ieinsum(eq, w_hi, x) >> 8) + (ieinsum(eq, w_lo, x) >> 16)


def _floor_log2_i(x):
    e = torch.zeros_like(x)
    for k in (16, 8, 4, 2, 1):
        big = x >= (1 << k)
        e = e + torch.where(big, k, 0)
        x = torch.where(big, x >> k, x)
    return e


def _qdelta(a, b):
    """4-bit sign+log-magnitude quantization of a byte difference."""
    d = a - b
    mag = d.abs()
    e = torch.zeros_like(mag)
    for k in (4, 2, 1):
        big = mag >= (1 << k)
        e = e + torch.where(big, k, 0)
        mag = torch.where(big, mag >> k, mag)
    lg = torch.where(d.abs() > 0, e + 1, 0)
    return torch.clamp(lg, max=7) * 2 + (d < 0).long()


def _winner_pos(flat):
    """Deterministic duplicate-scatter rule: for every entry of ``flat``
    (row-major over (block, k); indices unique within a block) the flat
    position of the entry that wins its index -- the highest block."""
    srt, perm = torch.sort(flat, stable=True)
    n = flat.numel()
    pos = torch.arange(n, device=flat.device)
    is_last = torch.ones(n, dtype=torch.bool, device=flat.device)
    is_last[:-1] = srt[1:] != srt[:-1]
    cand = torch.where(is_last, pos, n)
    run_end = torch.flip(torch.cummin(torch.flip(cand, [0]), 0).values, [0])
    win = torch.empty_like(perm)
    win[perm] = perm[run_end]
    return win


def _set_rows(tbl2d, flat_idx, vals, comm=None, key=None):
    """``tbl2d[flat_idx] = vals`` with duplicates resolved by
    ``_winner_pos`` (every duplicate writes the winner's row).  With a
    sharded step's ``comm`` (``parallel/mesh.py``) ``tbl2d`` is this rank's
    slice of the table ``key`` and only its rows are written."""
    f = flat_idx.reshape(-1)
    v = vals.reshape((f.numel(),) + tuple(tbl2d.shape[1:]))
    if comm is None:
        tbl2d[f] = v[_winner_pos(f)]
    else:
        comm.set_rows(key, tbl2d, f, v[_winner_pos(f)])


def _rows(sh, key, idx, lead=None, comm=None):
    """``sh[key][lead, idx]`` (``sh[key][idx]`` without ``lead``): rows of
    one of the tables a sharded step splits over tp, read through its
    ``comm`` there."""
    if comm is not None:
        return comm.rows(key, sh[key], idx, lead)
    return sh[key][idx] if lead is None else sh[key][lead, idx]


def _masked_rows(tbl2d, idx, vals, ok):
    """(rows, values) that write ``tbl2d[idx[ok]] = vals[ok]`` for (N,)
    rows ``idx`` and (N, ...) ``vals`` in fixed shapes (no host sync, so a
    graph can capture it): an entry masked out repeats the write of the
    highest entry kept, or with none kept writes row 0 back as it is.  So
    duplicate rows carry the values they carry in ``vals``."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    h = torch.where(ok, pos, -1).max()
    some = h >= 0
    hc = h.clamp(min=0).view(1)
    f = torch.where(ok, idx, torch.where(some, idx.index_select(0, hc), 0))
    keep = torch.where(some, vals.index_select(0, hc), tbl2d[:1])
    return f, torch.where(ok.view((-1,) + (1,) * (vals.dim() - 1)), vals,
                          keep)


def _set_rows_where(tbl2d, idx, vals, ok):
    """``tbl2d[idx[ok]] = vals[ok]`` for (B,) rows ``idx`` and (B, ...)
    ``vals``, duplicates resolved by ``_winner_pos``, in fixed shapes
    (``_masked_rows``)."""
    _set_rows(tbl2d, *_masked_rows(tbl2d, idx, vals, ok))


def _scatter_add(n, idx, vals):
    """zeros(n, ...) with ``vals`` summed at ``idx`` (deterministic
    ``index_add_``: a sorted segment sum on CUDA)."""
    f = idx.reshape(-1)
    v = vals.reshape((f.numel(),) + tuple(vals.shape[idx.dim():]))
    return torch.zeros((n,) + tuple(v.shape[1:]), dtype=v.dtype,
                       device=v.device).index_add_(0, f, v)


def _rows_at(at):
    """-> the rows ``at`` of a table, or the table without ``at``."""
    return (lambda v: v) if at is None else (lambda v: v.index_select(0, at))


def _put_rows(w, f, rows):
    """``w[f] = rows`` in place, for rows ``f`` whose duplicates carry
    equal rows: the largest of each row's int32 bit patterns
    (``scatter_reduce_`` "amax"), which no order changes, so deterministic
    mode sorts nothing (``index_put_`` sorts ``f``), and the card's atomic
    max is the native integer one.  -> w"""
    bits = w.view(torch.int32)
    bits.scatter_reduce_(0, f.view((-1,) + (1,) * (rows.dim() - 1))
                         .expand_as(rows), rows.view(torch.int32), "amax",
                         include_self=False)
    return w


def _bank_gather(sh, rowi, comm=None):
    """``bank[m, rowi[:, m]]`` -> (B, N_BANK, 256) int32 rows (slot 0 is
    the row header: checksum and run channel)."""
    m = torch.arange(rowi.shape[1], device=rowi.device)[None, :]
    return _rows(sh, "bank", rowi, m, comm)


def _bank_scatter(sh, cfg, rowi, newrows, comm=None):
    """Row writes back into the bank; a row hit by several blocks takes
    the highest block's row (``_set_rows``)."""
    m = torch.arange(rowi.shape[1], device=rowi.device)[None, :]
    _set_rows(sh["bank"].view(-1, 256), m * cfg.rows + rowi, newrows, comm,
              "bank")


def _dyn3_gates(cs, pb, exp_byte, pdst, ptot):
    """The MIX_DYN3 layer-1 gate values: order-3 hash, strongest-match
    expected byte, PPM top-order confidence bucket, previous-word hash,
    analog delta pair."""
    l4 = cs["last4"]
    b1u, b2u, b3u = l4 & 0xFF, (l4 >> 8) & 0xFF, (l4 >> 16) & 0xFF
    sm = torch.argmax(pb["match_len"], dim=1)
    smb = torch.gather(exp_byte, 1, sm[:, None])[:, 0]
    has = pb["match_len"].max(dim=1).values > 0
    return [(cs["ohash"][:, 3] >> 20) & 2047,
            torch.where(has, smb + 1, 0),
            (torch.clamp(pdst[:, -1], max=15.0)
             + 16.0 * (ptot[:, -1] > 0).float()).long(),
            cs["last_word"] & 0xFF,
            _qdelta(b1u, b2u) | (_qdelta(b2u, b3u) << 4)]


def _dyn4_gates(g, C, cs, pb, x, above_l, b1):
    """The MIX_DYN4 layer-1 gate values: the LSTM/PPM/DMC stretches'
    average at the root node, bucketed; the full coarse class register;
    sentence position x word length; the first indirect value's byte; the
    grid nibble pair (above, left)."""
    a = x[:, C.aux_taps, 1]                                  # (B, 3)
    if g.port:                                               # st256 int32
        avg = (a[:, 0] + a[:, 1] + a[:, 2]) // 3
        aux_b = torch.clamp((avg >> 7) + 15, 0, 31).long()
    else:
        avg = (a[:, 0] + a[:, 1] + a[:, 2]) * (1.0 / 3.0)
        aux_b = torch.clamp(torch.floor(avg * 2.0) + 15, 0, 31).long()
    return [aux_b,
            cs["cls2reg"] & 0xFF,
            torch.clamp(cs["sentpos"] >> 2, max=7) * 8
            + torch.clamp(cs["wordlen"], max=7),
            pb["ind_val"][:, 0] & 0xFF,
            (torch.clamp(above_l, max=256) >> 4) * 16 + (b1 >> 4)]


def _jval_channel(port, C, jrows, jvalid):
    """A JVAL tier's stretch on the byte tree: the row's byte counts (plus
    1/16 each) as a distribution, split at every node as the LSTM's and
    PPM's are; 0 off the JPEG planes.  The sums run in sixteenths, in
    int32 as the JAX package's PORT twin (below 2^21; a node's numerator
    << 12 below 2^31); its float32 sums are these values exactly (multiples
    of 1/16 below 2^17), whatever their order."""
    jq = jrows.to(torch.int32) * 16 + 1
    jqc = torch.cat([torch.zeros_like(jq[:, :1]),
                     torch.cumsum(jq, dim=1).to(torch.int32)], dim=1)
    j_lo, j_hi, j_mid = jqc[:, C.lo], jqc[:, C.hi], jqc[:, C.mid]
    if port:
        jp12 = torch.clamp(((j_hi - j_mid) << 12)
                           // torch.clamp(j_hi - j_lo, min=1), 1, 4095)
        return torch.where(jvalid[:, None], _st256(jp12), 0)[:, None]
    jp = torch.clamp((j_hi - j_mid).float() * 0.0625
                     / torch.clamp((j_hi - j_lo).float() * 0.0625, min=1e-9),
                     1e-5, 1 - 1e-5)
    return torch.where(jvalid[:, None], _stretch_f(jp), 0.0)[:, None]


# ------------------------------------------------------------ per-byte ctxs


def _bank_bases_b(g, C, cs, ind_val, rec_vals, x86_st, x86_vals, dist_b1):
    """(B, N_BANK) u32 context values of the model bank (same order and
    hashes as cmix_tpu/engine.py _bank_bases_b at the ported gates; the
    bank's salt is its column index, so the order is the format).  The
    mix32 calls are batched: one over all (h, x) pairs."""
    oh = cs["ohash"]
    l4, l8 = cs["last4"], cs["last8"]
    b1 = l4 & 0xFF
    b2 = (l4 >> 8) & 0xFF
    b3 = (l4 >> 16) & 0xFF
    b4 = (l4 >> 24) & 0xFF
    b6 = (l8 >> 8) & 0xFF
    w, lw, lw2 = cs["word"], cs["last_word"], cs["last_word2"]
    stem, tag, clsreg = cs["last_stem"], cs["tag"], cs["clsreg"]
    linepos, sentpos = cs["linepos"], cs["sentpos"]
    wlen15 = torch.clamp(cs["wordlen"], max=15)
    brk = bracket_ctx(cs)
    above_l, v_alive = line_expected(cs)
    w2 = mix32(lw2, lw)                               # word bigram
    q12 = _qdelta(b1, b2)
    vals, pairs = [], []

    def raw(v):
        vals.append(v)

    def mix(h, x):
        vals.append(len(pairs))
        pairs.append((h, x))

    for o in (1, 2, 3, 4, 5, 6, 7, 8, 12, 16):
        raw(oh[:, o])                                            # 0-9
    raw(w)                                                       # 10
    mix(lw, b1)                                                  # 11
    raw((l4 >> 8) & 0xFF)
    raw((l4 >> 8) & 0xFFFF)
    raw((b4 << 8) | b2)
    raw((l4 >> 8) & 0xFFFFFF)                                    # 15
    raw(clsreg & 0xFFFFFF)
    mix(clsreg & 0xFFFF, w)
    raw(ind_val[:, 0])
    raw(b1)
    raw(l4 & 0xFFFF)                                             # 20
    raw(oh[:, 10])
    raw(oh[:, 20])
    mix(lw, w)
    raw(brk)                                                     # 24
    for j in range(4):
        raw(rec_vals[:, j])                                      # 25-28
    raw(cs["word_pfx"])
    raw(w2)                                                      # 30
    raw(cs["cls2reg"])
    mix(torch.clamp(sentpos, max=1023), b1)
    mix(w, wlen15)
    raw(oh[:, 24])
    mix(clsreg, 0xC2B2AE35)                                      # 35
    for j in range(4):
        raw(x86_vals[:, j])                                      # 36-39
    mix(b3 | (b6 << 8), 0x3C6EF372)                              # 40
    mix(((b1 + b2) >> 1) | (q12 << 8), 0xA54FF53A)
    mix(q12 | (_qdelta(b2, b3) << 4), 0x510E527F)
    mix(tag, cs["tagdepth"] + 0x9B)
    raw((b1 >> 4) | ((b2 >> 4) << 4) | ((b3 >> 4) << 8))
    mix(torch.clamp(linepos, max=511), b1)                       # 45
    mix(above_l, torch.clamp(linepos, max=255))
    mix(above_l | (b1 << 16), 0x165667B1)
    for j in range(1, g.n_ind):
        raw(ind_val[:, j])                                       # 48+
    if g.wiki:
        cell = cs["cellidx"]
        pcell = torch.gather(cs["pcellbuf"], 1, cell[:, None])[:, 0]
        mix(pcell | (cell << 16), 0x94D049BB)
        mix(cell | (cs["cellpos"] << 5) | (b1 << 16), 0xBF58476D)
        mix(cs["listdepth"] | (cs["listchar"] << 4)
            | (torch.clamp(linepos, max=63) << 12), 0xD6E8FEB8)
        mix(w, cell + 0x2F)
    # X86X: opcode-stream contexts; GRID2 and JPEGX: record-grid columns
    # 4.. of _record_ctx_vals
    if g.x86x:
        xe = x86_ext_vals(x86_st)
        if g.x86x >= 2:
            xe = torch.cat([xe, x86_ext_vals2(x86_st)], dim=1)
        for j in range(xe.shape[1]):
            raw(xe[:, j])
    for j in range(4, rec_vals.shape[1]):
        raw(rec_vals[:, j])
    if g.stemx:
        mix(stem, 0x85EBCA77)
        mix(stem, (w + 0x1D) & M32)
    if g.ctx2:
        mix(w2, (w + 0x6A09) & M32)
        mix(w, b1 + 0xBB67)
        mix(w, torch.clamp(sentpos >> 3, max=31) + 0x3C6E)
        mix(cs["wtail"], wlen15 + 0xA54F)
        mix(tag, b1 + 0x510E)
        mix(b1 | (b3 << 8) | (b4 << 16), 0x9B05688C)
        mix(stem, b1 + 0x1F83)
        mix(clsreg & 0xFFF, torch.clamp(linepos, max=63) + 0x5BE0)
    if g.ctx3:
        mix(b2 | (b4 << 8), 0x71374491)
        mix((l8 & 0xFF) | (((l8 >> 16) & 0xFF) << 8), 0xB5C0FBCF)
        mix((l4 | 0x20202020) & 0xFFFFFF, 0xE9B5DBA5)
        mix(l4 & 0xF0F0F0F0, 0x3956C25B)
        mix(w, cs["cls2reg"] + 0x59F1)
        mix(lw, torch.clamp(sentpos, max=255) + 0x923F)
        raw(oh[:, 14])
        mix(cs["word_pfx"], b1 + 0xAB1C)
    if g.ctx4:
        d = torch.clamp(dist_b1, min=1)
        dkey = torch.where(d < 32, d, 32 + _floor_log2_i(d))
        vw = torch.zeros_like(b1)
        for j in range(4):
            lj = (cs["wtail"] >> (8 * j)) & 0xFF
            vw = vw | (C.is_vowel[lj] << j)
        mix(stem, (w + 0xC67178F2) & M32)
        mix(clsreg, 0xD5A79147)
        mix(b1 | (dkey << 8), 0x06CA6351)
        mix(w2, b1 + 0x14292967)
        mix(l4 | 0x20202020, 0x27B70A85)
        mix(vw | (wlen15 << 4), b1 + 0x2E1B2138)
        mix(tag, (w + 0x4D2C6DFC) & M32)
        mix(brk, (w + 0x53380D13) & M32)
    hs = torch.stack([h for h, _ in pairs], dim=1)
    xs = torch.stack([x if torch.is_tensor(x) else torch.full_like(b1, x)
                      for _, x in pairs], dim=1)
    mixed = mix32(hs, xs)
    v = torch.stack([mixed[:, e] if isinstance(e, int) else e
                     for e in vals], dim=1)                  # (B, NB)
    return mix32(v, C.bank_salt[None, :]), brk, above_l, v_alive


def _record_rl(pb):
    """The record length: forced by a media segment, else the voted one
    once two equal gaps confirmed it, else 1."""
    rl = torch.where(pb["rec_cnt"] >= 2, pb["rec_len"], 1)
    return torch.where(pb["rec_forced"] > 0, pb["rec_forced"], rl)


def _jpeg_coords(pb, t):
    """(component, zigzag) address of byte t inside a recoded-JPEG
    segment's coefficient planes -> (ck (B,): comp << 6 | k, or 4095 off the
    planes; valid (B,); clc (B,) the component's plane length).  The JAX
    package computes in int32; every value here fits int32, and the
    division floors as its ``//`` does (negative offsets in the header)."""
    body = pb["jpeg_rel0"] + t
    cl = pb["jpeg_clen"]
    csz = 64 * cl
    c1 = csz[:, 0]
    c2 = c1 + csz[:, 1]
    c3 = c2 + csz[:, 2]
    comp = (body >= c1).long() + (body >= c2).long() + (body >= c3).long()
    base = torch.where(comp == 0, 0, torch.where(
        comp == 1, c1, torch.where(comp == 2, c2, c3)))
    clc = torch.gather(cl, 1, comp[:, None])[:, 0]
    k = torch.div(body - base, torch.clamp(clc, min=1), rounding_mode="floor")
    valid = ((body >= 0) & (clc > 0) & (k < 64)
             & (pb["jpeg_rel0"] > -(1 << 29)))
    return torch.where(valid, (comp << 6) | k, 4095), valid, clc


def _record_ctx_vals(cfg, g, C, pb, t):
    """Record-grid context values (B, 4 + 2*GRID2 + 8*JPEGX) u32: byte
    above, two-above, column; GRID2's pixel neighbourhood (NW+N, N+NE+W);
    JPEGX's coefficient-plane contexts.  Every history byte they read is
    one gather at stacked offsets (mod the block, as the JAX package).
    -> (values, record length, column, jx): jx is JVAL's direct rows
    (``jctx``, at JVAL=2 ``jctx2``: 0 off the planes) and ``jvalid``, else
    None."""
    rl = _record_rl(pb)
    n = cfg.block_size
    tt = t.expand_as(rl)
    posr = torch.remainder(tt, torch.clamp(rl, min=1))
    offs = [tt - rl, tt - 2 * rl]
    if g.grid2:
        offs += [tt - rl - 1, tt - rl + 1, tt - 1]
    if g.jpegx:
        ck, valid, clc = _jpeg_coords(pb, t)
        stride = torch.clamp(rl, min=1)
        offs += [tt - 1, tt - 2] + [tt - j * clc for j in (1, 2, 3, 4)] \
            + [tt - clc - stride, tt - stride + 1]
    nb = torch.gather(pb["hist"], 1, torch.remainder(
        torch.stack(offs, dim=1), n)).long()
    above, above2 = nb[:, 0], nb[:, 1]
    hs = [above, above | (above2 << 8), posr, above << 8]
    xs = [rl, torch.full_like(rl, 0x51ED2701), rl << 8, posr]
    if g.grid2:
        nw, ne, lf = nb[:, 2], nb[:, 3], nb[:, 4]
        hs += [nw | (above << 8), above | (ne << 8) | (lf << 16)]
        xs += [torch.full_like(rl, 0x632BE5AB),
               torch.full_like(rl, 0x9E3779B1)]
    if g.jpegx:
        j0 = 2 + 3 * g.grid2
        lfj, lfj2 = nb[:, j0], nb[:, j0 + 1]
        kq = ck & 63
        # the block's previous zigzag coefficients (one plane back each),
        # the north block's k-1 and the north-east same-k; a position off
        # the planes reads the sentinel 0x1FF
        vk = [(kq >= j) & valid for j in (1, 2, 3, 4)]
        sent = torch.full_like(rl, 0x1FF)
        pk1, pk2, pk3, pk4 = (torch.where(vk[j], nb[:, j0 + 2 + j], sent)
                              for j in range(4))
        nk1 = torch.where(vk[0], nb[:, j0 + 6], sent)
        ne = torch.where(valid, nb[:, j0 + 7], sent)
        mq = torch.bucketize(
            (torch.stack([above, lfj, pk1 & 0xFF, pk2 & 0xFF, nk1, ne], 1)
             - 128).abs(), C.magq_bounds, right=True)
        m_above, m_lfj, m_pk1, m_pk2, m_nk1, m_ne = mq.unbind(1)
        z4 = ((pk1 == 128).long() | ((pk2 == 128).long() << 1)
              | (torch.where(vk[2], (pk3 == 128).long(), 2) << 2)
              | (torch.where(vk[3], (pk4 == 128).long(), 2) << 4))
        hs += [above | (lfj << 8), ck | (m_above << 12) | (m_lfj << 16), ck,
               lfj | (lfj2 << 8), pk1 | (pk2 << 9),
               m_pk1 | (m_pk2 << 4) | (m_above << 8), z4 | (m_pk1 << 6),
               m_nk1 | (m_ne << 4) | (m_above << 8) | (m_lfj << 12)]
        xs += [ck + 0x7F4A7C15, torch.full_like(rl, 0xE6546B64),
               torch.full_like(rl, 0x2545F491), ck + 0x9E3779B9,
               ck + 0xC2B2AE3D, ck + 0x27D4EB2F, ck + 0x165667B1,
               ck + 0x85EBCA6B]
    jx = None
    if g.jval:
        # component x zigzag band x magnitude(N) x magnitude(W)
        comp = ck >> 6
        jctx = ((comp * 10 + C.jband[kq]) * 8 + m_above) * 8 + m_lfj
        jx = dict(jctx=torch.where(valid, jctx, 0), jvalid=valid)
        if g.jval >= 2:
            jx["jctx2"] = torch.where(valid, ck, 0)       # comp * 64 + k
    return (mix32(torch.stack(hs, 1), torch.stack(xs, 1) & M32), rl,
            posr, jx)


# --------------------------------------------------------------- range coder


def _coder_bit_b(cd, comp, enc_bit, p16, mode):
    """One shared coder step, batched (B,) (cf. coder/rangecoder.py).
    Returns (cd, bit, e32 packed emissions, k)."""
    x1, x2, xc = cd["x1"], cd["x2"], cd["xc"]
    r = x2 - x1
    xmid = (x1 + (r >> 16) * p16 + (((r & 0xFFFF) * p16) >> 16)) & M32
    dec_bit = (xc <= xmid).long()
    bit = torch.where(mode == MODE_ENCODE, enc_bit, dec_bit)
    x1 = torch.where(bit == 1, x1, (xmid + 1) & M32)
    x2 = torch.where(bit == 1, xmid, x2)
    rptr = cd["rptr"]
    nlen = comp.shape[1]
    e32 = torch.zeros_like(x1)
    k = torch.zeros_like(rptr)
    for i in range(4):
        cond = ((x1 ^ x2) & 0xFF000000) == 0
        e32 = e32 | torch.where(cond, (x2 >> 24) << (24 - 8 * i), 0)
        nb = torch.gather(comp, 1, torch.clamp(rptr, 0, nlen - 1)[:, None]
                          )[:, 0].long()
        x1 = torch.where(cond, (x1 << 8) & M32, x1)
        x2 = torch.where(cond, ((x2 << 8) & M32) | 0xFF, x2)
        xc = torch.where(cond, ((xc << 8) & M32) | nb, xc)
        rptr = rptr + cond.long()
        k = k + cond.long()
    cd = dict(cd, x1=x1, x2=x2, xc=xc, total=cd["total"] + k, rptr=rptr)
    return cd, bit, e32, k


# ----------------------------------------------------------- tree predictor


def _ppm_blend_f32(sh, ppm_rows, C, p_idx, excl):
    """f32 PPM escape blend; ``excl`` (PPM_EXCL): symbol exclusion, a
    symbol counted at a higher order drops out of the lower orders and the
    fallback is uniform over the never-seen symbols.
    Returns (st_ppm, pcnt_eff, ptot, pdst, see_d, see_t, see_p)."""
    if excl:
        rev = torch.flip(ppm_rows, [1])                      # high order 1st
        seen_i = torch.cumsum((rev > 0).long(), dim=1)       # exact counts
        seen_above = torch.cat([torch.zeros_like(seen_i[:, :1]),
                                seen_i[:, :-1]], dim=1)
        pcnt = torch.flip(torch.where(seen_above > 0, 0, rev), [1]).float()
        unseen = (seen_i[:, -1, :] == 0).float()
        n_uns = unseen.sum(dim=1, keepdim=True)
        fb = torch.where(n_uns > 0, unseen / torch.clamp(n_uns, min=1.0),
                         1.0 / 256.0)
    else:
        pcnt = ppm_rows.float()
        fb = 1.0 / 256.0
    ptot = pcnt.sum(dim=2)
    pdst = (pcnt > 0).float().sum(dim=2)
    see_d = torch.clamp(pdst, max=SEE_DIST_B - 1).long()
    see_t = torch.clamp(torch.log2(ptot + 1.0), 0, SEE_TOT_B - 1).long()
    see_p = sh["ppm_see"][p_idx[None, :], see_d, see_t]
    pesc = torch.where(ptot > 0, see_p, 1.0)
    esc_rev = torch.flip(pesc, [1])
    wcum = torch.cat([torch.ones_like(esc_rev[:, :1]),
                      cumprod_last(esc_rev[:, :-1])], dim=1)
    w_ord = torch.flip(wcum * (1.0 - esc_rev), [1])
    pnorm = pcnt / torch.clamp(ptot, min=1.0)[:, :, None]
    q = torch.bmm(w_ord[:, None, :], pnorm)[:, 0] \
        + (wcum[:, -1] * esc_rev[:, -1])[:, None] * fb
    pqcum = cumsum0_last(q)
    q_lo, q_hi, q_mid = pqcum[:, C.lo], pqcum[:, C.hi], pqcum[:, C.mid]
    p_ppm = torch.clamp((q_hi - q_mid) / torch.clamp(q_hi - q_lo, min=1e-9),
                        1e-5, 1 - 1e-5)
    return (_stretch_f(p_ppm)[:, None, :], pcnt, ptot, pdst, see_d, see_t,
            see_p)


def _ppm_blend_int(sh, ppm_rows, C, p_idx, excl):
    """Integer twin of _ppm_blend_f32 (portable profile): the distribution
    in 16-bit fixed point, escapes in p12, node probabilities by exact
    integer division, st256 through intmath.  All int32."""
    i32 = torch.int32
    B, n_ppm = ppm_rows.shape[:2]
    if excl:
        rev = torch.flip(ppm_rows, [1])                      # high order 1st
        seen = torch.cumsum((rev > 0).to(i32), dim=1).to(i32)
        seen_above = torch.cat([torch.zeros_like(seen[:, :1]),
                                seen[:, :-1]], dim=1)
        pcnt = torch.flip(torch.where(seen_above > 0, 0, rev), [1])
        unseen = (seen[:, -1, :] == 0).to(i32)               # (B, 256)
        n_uns = unseen.sum(dim=1, keepdim=True).to(i32)
        fb16 = torch.where(n_uns > 0,
                           unseen * (65536 // torch.clamp(n_uns, min=1)),
                           256)
    else:
        pcnt = ppm_rows.to(i32)
        fb16 = torch.full((B, 256), 256, dtype=i32, device=ppm_rows.device)
    ptot = pcnt.sum(dim=2).to(i32)                           # (B, NP)
    pdst = (pcnt > 0).sum(dim=2).to(i32)
    see_d = torch.clamp(pdst, max=SEE_DIST_B - 1).long()
    see_t = torch.clamp(_floor_log2_i(ptot + 1), max=SEE_TOT_B - 1).long()
    see_p = sh["ppm_see"][p_idx[None, :], see_d, see_t]      # (B, NP) p12
    esc_rev = torch.flip(torch.where(ptot > 0, see_p, 4096), [1])
    wcum = [torch.full((B,), 65536, dtype=i32, device=ppm_rows.device)]
    for j in range(n_ppm - 1):
        wcum.append((wcum[-1] * esc_rev[:, j]) >> 12)
    wcum = torch.stack(wcum, dim=1)                          # (B, NP)
    w_ord = torch.flip(((wcum >> 4) * ((4096 - esc_rev) >> 2)) >> 6, [1])
    pnorm16 = (pcnt << 16) // torch.clamp(ptot, min=1)[:, :, None]
    q16 = ((((w_ord[:, :, None] >> 4) * (pnorm16 >> 4)) >> 8)
           .sum(dim=1).to(i32))                              # (B, 256)
    w_fb = (wcum[:, -1] * esc_rev[:, -1]) >> 12
    q16 = q16 + (((w_fb[:, None] >> 4) * (fb16 >> 4)) >> 8)
    pqcum = torch.cat([torch.zeros_like(q16[:, :1]),
                       torch.cumsum(q16, dim=1).to(i32)], dim=1)
    q_lo, q_hi, q_mid = pqcum[:, C.lo], pqcum[:, C.hi], pqcum[:, C.mid]
    p12 = torch.clamp(((q_hi - q_mid) << 12)
                      // torch.clamp(q_hi - q_lo, min=1), 1, 4095)
    return _st256(p12)[:, None, :], pcnt, ptot, pdst, see_d, see_t, see_p


def _predict_tree_b(cfg, g, C, sh, pb, t, comm=None, part=None):
    """Predictions for all 256 tree nodes of the current byte, batched.
    Returns (p_tree f32 (B, 256), aux dict threaded to _update_tree_b).
    A sharded step's ``comm`` reads the tp tables and holds every lane's
    history (match cursors point into any block); ``part`` marks the
    routed work (``ROUTED``) inside the ``predict`` part."""
    part = part or _no_part
    cs = pb["ctx"]
    node, level = C.node, C.level
    dev = node.device
    # the record grid's contexts, its four base columns included, where
    # GRID2's and JPEGX's columns widen it
    grid = g.grid2 or g.jpegx
    if grid:
        part(ROUTED)
    rec_vals, rec_rl, rec_posr, jx = _record_ctx_vals(cfg, g, C, pb, t)
    if grid:
        part("predict")
    x86_vals, x86_gate = x86_ctx_vals(pb["x86"])
    dist_b1 = None
    if g.ctx4:
        b1i = cs["last4"] & 0xFF
        dist_b1 = torch.gather(pb["rec_stride"], 1, b1i[:, None])[:, 0]
    bases, brctx, above_l, v_alive = _bank_bases_b(
        g, C, cs, pb["ind_val"], rec_vals, pb["x86"], x86_vals, dist_b1)
    B = bases.shape[0]

    # ---- bank rows: BANK_CK=2 probes 2-way set-associative rows by
    # checksum, replacing the less mature way on a double miss; another
    # BANK_CK reads a row whose checksum mismatches as fresh; 0 reads it
    rowi = (bases >> 8) & (cfg.rows - 1)
    ck_exp = bases & 0xFF if g.bank_ck else None
    if g.bank_ck == 2:
        alt = rowi ^ 1
        rows_a = _bank_gather(sh, rowi, comm)                # (B, NB, 256)
        rows_b = _bank_gather(sh, alt, comm)
        ok_a = (rows_a[:, :, 0] >> 16).long() == ck_exp
        ok_b = (rows_b[:, :, 0] >> 16).long() == ck_exp
        mat_a = rows_a[:, :, 1] & 0x3F
        mat_b = rows_b[:, :, 1] & 0x3F
        pick_b = (~ok_a) & (ok_b | (mat_b <= mat_a))
        rowi = torch.where(pick_b, alt, rowi)
        rows = torch.where(pick_b[:, :, None], rows_b, rows_a)
        hdr = rows[:, :, 0].long()
        rows = torch.where((ok_a | ok_b)[:, :, None], rows, SLOT_INIT)
    else:
        rows = _bank_gather(sh, rowi, comm)
        hdr = rows[:, :, 0].long()
        if g.bank_ck:
            rows = torch.where(((hdr >> 16) == ck_exp)[:, :, None], rows,
                               SLOT_INIT)
    port = g.port
    # the model inputs: f32 stretches, or st256 int32 under PORT
    st_of = _st256 if port else _stretch_f
    if port:
        st_bank = _packed_st256(rows, 18)
    else:
        st_bank = ((rows >> 18).float() - 4096.0) * (1.0 / 256.0)

    b1 = cs["last4"] & 0xFF
    st_d0 = st_of(sh["d0_p"])[None].expand(B, 256)
    b2 = cs["last4"] & 0xFFFF
    d12_idx = torch.stack([b1, 256 + b2, D12_BRK + brctx], dim=1)
    d12rows = _rows(sh, "d12", d12_idx, comm=comm)           # (B, 3, 256)
    if port:
        st_d12 = _packed_st256(d12rows, 18)
    else:
        st_d12 = ((d12rows >> 18).float() - 4096.0) * (1.0 / 256.0)

    # ---- match models (cursors may point into any block's history)
    hist, nlanes = (pb["hist"], B) if comm is None else (comm.hist,
                                                         comm.n_lanes)
    lvl = level[None, None, :]

    def _match(blk, pos, mlen, conf_tbl):
        blk = torch.where(blk < 0, blk + nlanes, blk)        # JAX wraps
        exp_byte = hist[blk, torch.clamp(pos, 0, cfg.block_size - 1)].long()
        lenb = torch.clamp(mlen, max=31)
        conf = _take_cols(conf_tbl, lenb)
        exp_pref = (1 << lvl) + (exp_byte[:, :, None] >> (8 - lvl))
        alive = (node[None, None, :] == exp_pref) & (mlen > 0)[:, :, None]
        exp_bit = (exp_byte[:, :, None] >> (7 - lvl)) & 1
        st = _vote(alive, exp_bit, st_of(conf))
        return exp_byte, lenb, conf, alive, exp_bit, st

    exp_byte, lenb, conf, alive, exp_bit, st_match = _match(
        pb["mp_blk"], pb["mp_pos"], pb["match_len"], sh["match_conf"])
    m2, mt2 = [], None
    if g.match2:
        # the second candidates: the older position of each key
        _, lenb2, conf2, alive2, exp_bit2, st_match2 = _match(
            pb["mp2_blk"], pb["mp2_pos"], pb["match2_len"],
            sh["match2_conf"])
        m2 = [st_match2]
        mt2 = dict(exp_bit=exp_bit2, alive=alive2, conf=conf2, lenb=lenb2)

    zero_ch = torch.zeros((B, 1, 256), device=dev,
                          dtype=torch.int32 if port else torch.float32)
    if cfg.lstm_hidden:
        qcum = pb["lstm"]["qcum"]
        tot_lo, tot_hi, mid = qcum[:, C.lo], qcum[:, C.hi], qcum[:, C.mid]
        if port:
            p12l = torch.clamp(((tot_hi - mid) << 12)
                               // torch.clamp(tot_hi - tot_lo, min=1),
                               1, 4095)
            st_lstm = _st256(p12l)[:, None, :]
        else:
            denom = torch.clamp(tot_hi - tot_lo, min=1e-3)
            p_lstm = torch.clamp((tot_hi - mid) / denom, 1e-5, 1 - 1e-5)
            st_lstm = _stretch_f(p_lstm)[:, None, :]
    else:
        st_lstm = zero_ch

    # ---- PPM: escape-blended multi-order byte distribution
    pcols = [cs["ohash"][:, o] if o <= 24 else pb["h32" if o == 32
                                                   else "h48"]
             for o in g.ppm_orders]
    pbase = mix32(torch.stack(pcols, dim=1), C.psalt[None, :])
    prowi = (pbase >> 8) & (cfg.prows - 1)
    p_ar = torch.arange(g.n_ppm, device=dev)
    ppm_w = _rows(sh, "ppm", prowi, p_ar[None, :], comm)     # (B, NP, 64)
    ppm_rows = torch.stack([(ppm_w >> (8 * j)) & 0xFF for j in range(4)],
                           dim=-1).reshape(B, g.n_ppm, 256)
    pck_exp = None
    if g.ppm_ck:
        pck_exp = (pbase & 0xFF).to(torch.int32)
        pck_ok = sh["ppm_ck"][p_ar[None, :], prowi] == pck_exp
        ppm_rows = torch.where(pck_ok[:, :, None], ppm_rows, 0)
    (st_ppm, pcnt, ptot, pdst, see_d, see_t,
     see_p) = (_ppm_blend_int if port else _ppm_blend_f32)(
        sh, ppm_rows, C, p_ar, g.ppm_excl)

    # ---- state bank: packed (state | st13) slots, one row gather
    srowi = (mix32(bases[:, C.scols], C.ssalt[None, :]) >> 8) \
        & (cfg.rows - 1)
    s_ar = torch.arange(g.n_sbank, device=dev)
    srows = _rows(sh, "sbank", srowi, s_ar[None, :], comm)   # (B, NS, 256)
    if port:
        st_sbank = _packed_st256(srows, 8)
    else:
        st_sbank = ((srows >> 8).float() - 4096.0) * (1.0 / 256.0)

    # ---- DMC: apply the previous byte's pending updates, then walk
    if cfg.dmc_nodes:
        dmc_new, dmc_walk = dmc.predict_step(
            {k: pb[k] for k in dmc.DMC_STATE_KEYS}, g.dmc_levels)
        pb.update(dmc_new)
        if port:
            st_dmc = _st256(dmc.p12_from_counts(dmc_walk["cw"]))[:, None]
        else:
            st_dmc = _stretch_f(dmc.probs_from_counts(dmc_walk["cw"])
                                )[:, None]
    else:
        dmc_walk = None
        st_dmc = zero_ch

    # ---- strided LMS: a linear prediction of the byte from the bytes 1..4
    # records back votes its tree path (LMS=2: media blocks only)
    lms, lm = None, []
    if g.lms:
        part(ROUTED)
        rl = rec_rl[:, None] * C.lms_k[None, :]
        xs = torch.gather(pb["hist"], 1, torch.remainder(t - rl,
                                                         cfg.block_size)
                          ).float()
        xs_f = (xs - 128.0) * (1.0 / 128.0)
        predf = torch.clamp((pb["lms_w"] * xs_f).sum(dim=1), -1.0, 1.0)
        pbyte = torch.clamp(torch.round(predf * 128.0 + 128.0), 0, 255
                            ).long()
        errb = torch.clamp(pb["lms_err"] * 32.0, 0, 15).long()
        lconf = sh["lms_conf"][errb]
        l_on = node[None, :] == (1 << lvl[0]) + (pbyte[:, None]
                                                  >> (8 - lvl[0]))
        l_bit = (pbyte[:, None] >> (7 - lvl[0])) & 1
        st_lms = torch.where(l_on, torch.where(l_bit == 1, 1.0, -1.0)
                             * _stretch_f(lconf)[:, None], 0.0)
        med = None
        if g.lms == 2:
            med = (pb["blk_kind"] >= 3) & (pb["blk_kind"] <= 7)
            st_lms = torch.where(med[:, None], st_lms, 0.0)
        lm = [st_lms[:, None]]
        lms = dict(xs=xs_f, pred=predf, pbyte=pbyte, errb=errb, conf=lconf,
                   med=med)
        part("predict")

    # ---- vertical match (VMATCH): the previous line's byte at this column
    # votes its tree path, its confidence learned per matched-prefix length
    vm, vmx = [], None
    if g.vmatch:
        vlml = torch.clamp(cs["lml"], max=31)
        vconf = sh["vmatch_conf"][vlml]
        vexp = torch.where(v_alive, above_l, 0)
        v_on = v_alive[:, None] & (node[None, :] == (1 << lvl[0])
                                   + (vexp[:, None] >> (8 - lvl[0])))
        v_bit = (vexp[:, None] >> (7 - lvl[0])) & 1
        vm = [torch.where(v_on, torch.where(v_bit == 1, 1.0, -1.0)
                          * _stretch_f(vconf)[:, None], 0.0)[:, None]]
        vmx = dict(vlml=vlml, vconf=vconf, vexp=vexp, valive=v_alive)

    # ---- run channels (RUNX) from the bank rows' header slot
    rx, rxd = [], None
    if g.runx:
        rx_rows = hdr[:, :g.runx_n] & 0xFFFF
        rx_byte = (rx_rows >> 8) & 0xFF
        rx_cnt = rx_rows & 0xFF
        rx_b = torch.clamp(_floor_log2_i(rx_cnt + 1), max=7)
        rx_conf = _take_cols(sh["runx_conf"], rx_b)
        rx_pref = (1 << lvl) + (rx_byte[:, :, None] >> (8 - lvl))
        rx_alive = ((node[None, None, :] == rx_pref)
                    & (rx_cnt > 0)[:, :, None])
        rx_bit = (rx_byte[:, :, None] >> (7 - lvl)) & 1
        rx = [_vote(rx_alive, rx_bit, st_of(rx_conf))]
        rxd = dict(exp_bit=rx_bit, alive=rx_alive, conf=rx_conf, lenb=rx_b)

    # ---- JPEG coefficient values (JVAL): the byte distribution of the
    # direct (comp, band, magN, magW) row and, at JVAL=2, of the
    # (comp, zigzag position) row
    jv, jrows = [], []
    if g.jval:
        jrows = [sh["jval"][jx["jctx"]]]                     # (B, 256) u8
        if g.jval >= 2:
            jrows.append(sh["jval2"][jx["jctx2"]])
        jv = [_jval_channel(port, C, r, jx["jvalid"]) for r in jrows]

    parts = [st_bank, st_d0[:, None, :], st_d12, st_match, st_lstm, st_ppm,
             st_sbank, st_dmc] + lm + vm + m2 + rx + jv
    if g.bank_ch > 1 and port:
        cnti = rows & 0x3F
        conf12 = (cnti << 12) // (cnti + 2)                  # p12
        parts.append((st_bank * conf12) >> 12)
        if g.bank_ch > 2:
            parts.append(conf12 - 2048)                      # +-2048 st256
    elif g.bank_ch > 1:
        cntf = (rows & 0x3F).float()
        bconf = cntf / (cntf + 2.0)
        parts.append(st_bank * bconf)
        if g.bank_ch > 2:
            parts.append(2.0 * bconf - 1.0)
    x = torch.cat(parts, dim=1)                              # (B, NIN, 256)

    ml_on = pb["match_len"] > 0
    longest = (torch.where(ml_on, lenb, 0).max(dim=1).values * 2
               + torch.where(ml_on, (exp_byte >> 7) & 1, 0).max(dim=1).values)
    dyn_idx = torch.stack([
        b1,
        (cs["ohash"][:, 2] >> 22) & 1023,
        longest,
        (cs["word"] >> 24) & 0xFF,
        cs["clsreg"] & 0xFF,
        torch.clamp(cs["linepos"], max=63),
        brctx,
        torch.clamp(rec_posr, max=63) * 2 + (pb["rec_cnt"] >= 2).long(),
        x86_gate,
    ] + ([                                                   # MIX_DYN2
        torch.clamp(above_l, max=256),
        (cs["last4"] >> 8) & 0xFF,
        torch.clamp(cs["wordlen"], max=15) * 4 + (cs["cls2reg"] & 3),
        cs["tag"] & 0xFF,
    ] if g.mix_dyn2 else [])
        + (_dyn3_gates(cs, pb, exp_byte, pdst, ptot) if g.mix_dyn3 else [])
        + (_dyn4_gates(g, C, cs, pb, x, above_l, b1) if g.mix_dyn4 else [])
        # MIX_KIND: the block's content kind x the low class bits
        + ([torch.clamp(pb["blk_kind"], 0, 7) * 8 + (cs["cls2reg"] & 7)]
           if g.mix_kind else []), dim=1) \
        + C.mix1_off[None, :]                                # (B, ND)
    w1 = sh["w1"]
    w_dyn = w1[dyn_idx]                                      # (B, ND, NIN)
    w_const = w1[0]
    w_level = w1[1:9]
    if port:
        # integer dots (hi/lo weight split, _idot): biases are kept at a
        # 16-bit fraction, >> 8 brings them to the st256 dot domain
        dots = torch.cat([_idot("n,bnk->bk", w_const, x)[:, None],
                          _idot("kn,bnk->bk", w_level[level], x)[:, None],
                          _idot("bin,bnk->bik", w_dyn, x)], dim=1)
        dots = torch.clamp(dots + (sh["bias1"][None] >> 8), -3071, 3071)
        p1 = squash12_lut(dots + 4096)                       # p12
        st1 = dots                                           # st256
    else:
        dot_const = torch.einsum("n,bnk->bk", w_const, x)
        dot_dyn = torch.bmm(w_dyn, x)                        # (B, ND, 256)
        dot_level = (w_level[level].t()[None] * x).sum(dim=1)
        dots = torch.cat([dot_const[:, None], dot_level[:, None], dot_dyn],
                         dim=1) + sh["bias1"][None]
        p1 = torch.sigmoid(dots)
        st1 = torch.clamp(dots, -ST_CLAMP, ST_CLAMP)         # (B, M1, 256)

    if g.mix_aux:
        # the LSTM/PPM/DMC stretches fed raw into layer 2 beside layer 1
        st1 = torch.cat([st1, x[:, C.aux_taps]], dim=1)     # (B, M2IN, 256)
    # the root state of the order-2 state-bank model (``sbank_gate``)
    st_o2 = (srows[:, g.sbank_gate, 1] & 0xFF).long()
    clsg = cs["clsreg"] & 63
    dyn2_idx = w2x_rows = None
    if g.mix2x:
        dyn2_idx = torch.stack([
            cs["word"] & 63,
            longest,
            (cs["ohash"][:, 2] >> 17) & 0xFF,
            st_o2,                                           # order-2 state
            torch.clamp(cs["linepos"], max=63) * 4 + (cs["cls2reg"] & 3),
        ], dim=1) + C.mix2_off[None, :]
        w2x_rows = sh["w2x"][dyn2_idx]                       # (B, 5, M2)
    w2n = sh["w2"][level]                                    # (256, M2)
    w3n = sh["w3"][level]                                    # (256, NL2)
    if port:
        dot2 = torch.cat([
            _idot("km,bmk->bk", w2n, st1)[:, None],
            _idot("bm,bmk->bk", sh["w2b"][b1], st1)[:, None],
            _idot("bm,bmk->bk", sh["w2c"][clsg], st1)[:, None]]
            + ([_idot("bjm,bmk->bjk", w2x_rows, st1)] if g.mix2x else []),
            dim=1)
        st2 = torch.clamp(dot2 + (sh["bias2"][None] >> 8), -3071, 3071)
        p2 = squash12_lut(st2 + 4096)
        st3 = torch.clamp(_idot("kj,bjk->bk", w3n, st2)
                          + (sh["bias3"][None] >> 8), -3071, 3071)
        p_mix = squash12_lut(st3 + 4096)                     # p12
    else:
        dot2 = torch.cat([
            (w2n.t()[None] * st1).sum(dim=1)[:, None],
            torch.bmm(sh["w2b"][b1][:, None], st1),
            torch.bmm(sh["w2c"][clsg][:, None], st1)]
            + ([torch.bmm(w2x_rows, st1)] if g.mix2x else []),
            dim=1) + sh["bias2"][None]
        p2 = torch.sigmoid(dot2)
        st2 = torch.clamp(dot2, -ST_CLAMP, ST_CLAMP)         # (B, NL2, 256)
        dot3 = (w3n.t()[None] * st2).sum(dim=1) + sh["bias3"][None]
        p_mix = torch.sigmoid(dot3)

    # ---- APM chain: interpolated SSE reads, then the final blend
    o2g = (cs["ohash"][:, 2] >> 17) & 0xFF
    apm_gates = [b1, 256 + longest, 320 + o2g]
    if g.apm2x:                          # word- and line/class-gated
        apm_gates += [576 + (cs["word"] & 0xFF),
                      832 + torch.clamp(cs["linepos"], max=63) * 4
                      + (cs["cls2reg"] & 3)]
    if g.apm3x:                          # the order-2 bit-history state
        apm_gates.append(576 + 512 * g.apm2x + st_o2)
    apm_idx = torch.stack(apm_gates, dim=1)                  # (B, NA)
    apm_rows = sh["apm"][apm_idx]                            # (B, NA, 33)
    p_tree12 = None
    # the coder's p16 comes from st256 under PORT (the mixer's st3), else
    # from f32 probabilities
    st_mix = st3 if port else _stretch_f(p_mix)
    tl, frac = _apm_pos(port, st_mix)
    pas = [_apm_read(port, apm_rows[:, j], tl, frac)
           for j in range(g.n_apm)]
    st_in = torch.stack([st_mix] + [st_of(p) for p in pas], dim=1)
    if g.apm_fixed:
        # the fixed blend 0.4 st(mix) + 0.6 st(mean of the APMs)
        if port:
            pa = torch.clamp(sum(pas) // g.n_apm, 1, 4095)
            st_fin = ((26214 * st3) >> 16) + ((39322 * _st256(pa)) >> 16)
        else:
            pa = torch.clamp(sum(pas) * (1.0 / g.n_apm), 1e-6, 1 - 1e-6)
            st_fin = 0.4 * st_mix + 0.6 * _stretch_f(pa)
    else:
        # learned, gated by the match state
        wa = sh["w_apm"][longest]                            # (B, 1+NA)
        st_fin = (_idot("bj,bjk->bk", wa, st_in) if port
                  else torch.bmm(wa[:, None], st_in)[:, 0])
    if port:
        st_fin = torch.clamp(st_fin, -3071, 3071)
    sse2 = None
    if g.sse2:
        # the serial stage: one more interpolated row gated by the order-2
        # bit-history state, then a learned 2-weight mix of its input and
        # its output
        rows2 = sh["apm"][g.sse2_base + st_o2]               # (B, 33)
        tl2, fr2 = _apm_pos(port, st_fin if port
                            else _stretch_f(torch.sigmoid(st_fin)))
        pa2 = _apm_read(port, rows2, tl2, fr2)
        ws = sh["w_sse"][st_o2]                              # (B, 2)
        if port:
            stf, stp = st_fin, _st256(pa2)
            ws_hi, ws_lo = ws >> 8, ws & 255

            def wmul(j, st):
                return (((ws_hi[:, j:j + 1] * st) >> 8)
                        + ((ws_lo[:, j:j + 1] * st) >> 16))
            st_fin = torch.clamp(wmul(0, stf) + wmul(1, stp), -3071, 3071)
        else:
            stf = torch.clamp(st_fin, -ST_CLAMP, ST_CLAMP)
            stp = _stretch_f(pa2)
            st_fin = ws[:, 0:1] * stf + ws[:, 1:2] * stp
        sse2 = dict(g=st_o2, rows=rows2, tl=tl2, frac=fr2, stf=stf, stp=stp)
    if port:
        p_tree = squash16_lut(st_fin + 4096)                 # p16
        p_tree12 = squash12_lut(st_fin + 4096)
    else:
        p_tree = torch.sigmoid(st_fin)

    aux = dict(rowi=rowi, rows=rows, ck_exp=ck_exp, hdr=hdr, b1=b1,
               d12_idx=d12_idx, prowi=prowi, ppm_rows=ppm_rows,
               pcnt_eff=pcnt, pck_exp=pck_exp, srowi=srowi, srows=srows,
               see_d=see_d, see_t=see_t, see_p=see_p, ptot=ptot,
               d12rows=d12rows, apm_idx=apm_idx, apm_rows=apm_rows,
               alive=alive, exp_bit=exp_bit, lenb=lenb, mt2=mt2, conf=conf,
               x=x,
               dyn_idx=dyn_idx, w_const=w_const, w_level=w_level, p1=p1,
               st1=st1, p_mix=p_mix, p2=p2, st2=st2, clsg=clsg,
               dyn2_idx=dyn2_idx, longest=longest, apm_tl=tl, apm_frac=frac,
               st_in=st_in, p_tree=p_tree, p_tree12=p_tree12, rxd=rxd,
               dmc_walk=dmc_walk,
               lms=lms, vmx=vmx, jx=jx, jrows=jrows, sse2=sse2)
    return p_tree, aux


# ------------------------------------------------------------- tree update


def _slot_update(slots, target, cap):
    """Adaptive counter update of packed slots toward target bits (f32);
    the count saturates at ``cap`` (CNT_CAP)."""
    cnt = (slots & 0x3F).float()
    p12 = ((slots >> 6) & 0xFFF).float()
    p = p12 * (1.0 / 4096.0)
    rate = 1.0 / (cnt + 1.6)
    newp = p + (target - p) * rate
    newc = torch.clamp(cnt + 1.0, max=float(cap))
    st13 = torch.clamp(_stretch_f(newp) * 256.0 + 4096.0, 0, 8191)
    return ((st13.int() << 18) | (torch.clamp(newp * 4096.0, 1, 4095).int()
                                  << 6) | newc.int())


def _slot_update_int(slots, target_i, cap):
    """Integer twin of _slot_update (portable profile): rate
    65536/(10*cnt+16) ~ 1/(cnt+1.6), st13 through intmath."""
    cnt = slots & 0x3F
    p12 = (slots >> 6) & 0xFFF
    r16 = 655360 // (10 * cnt + 16)
    newp = torch.clamp(p12 + (((target_i * 4096 - p12) * r16) >> 16),
                       1, 4095)
    newc = torch.clamp(cnt + 1, max=cap)
    return (stretch13_lut(newp) << 18) | (newp << 6) | newc


def _update_tree_b(cfg, g, C, sh, aux, byte, t, comm=None, part=None):
    """Adapt every model along each block's 8-node tree path (MIX_NORM,
    STAT_NORM, count-normalized final blend; integer twins under PORT).
    t: the byte index, a 0-d device tensor (MIX_TAU's rate decays with
    it, computed on the device).  A sharded step passes every lane's aux
    and byte and its ``comm``, which writes this rank's rows of the tp
    tables.  ``part`` marks the LMS's update (``ROUTED``) inside the
    ``update`` part."""
    part = part or _no_part
    lr = g.mix_lr
    if g.mix_tau:
        lr = g.mix_lr * torch.rsqrt(1.0 + t.float() / g.mix_tau)
    cap = g.cnt_cap
    level, node = C.level, C.node
    B = byte.shape[0]
    dev = byte.device
    port = g.port
    i32 = torch.int32
    lvl = level[None, :]
    pref = (1 << lvl) + (byte[:, None] >> (8 - lvl))
    onp_b = (node[None, :] == pref)
    onp_b[:, 0] = False
    on_path = onp_b.float()                                  # (B, 256)
    onp_i = onp_b.to(i32)
    target_i = ((byte[:, None] >> (7 - lvl)) & 1).to(i32)
    target = target_i.float()
    n8 = (1 << C.k8)[None, :] + (byte[:, None] >> (8 - C.k8)[None, :])
    t8_i = ((byte[:, None] >> (7 - C.k8)[None, :]) & 1).to(i32)
    t8 = t8_i.float()

    # ---- bank rows: masked in-row slot updates + the row header
    newrows = torch.where(
        onp_b[:, None, :],
        _slot_update_int(aux["rows"], target_i[:, None, :], cap) if port
        else _slot_update(aux["rows"], target[:, None, :], cap), aux["rows"])
    # the row header (slot 0): BANK_CK claims the checksum, RUNX refreshes
    # the run channel (the same byte extends the run, another restarts
    # it); with neither the header passes through
    hdr_old = aux["hdr"]
    if g.runx:
        ncnt = torch.where(((hdr_old >> 8) & 0xFF) == byte[:, None],
                           torch.clamp((hdr_old & 0xFF) + 1, max=255), 1)
        run16 = (byte[:, None] << 8) | ncnt
    else:
        run16 = hdr_old & 0xFFFF
    if g.runx or g.bank_ck:
        ck16 = aux["ck_exp"] if g.bank_ck else hdr_old >> 16
        newrows[:, :, 0] = ((ck16 << 16) | run16).to(torch.int32)
    _bank_scatter(sh, cfg, aux["rowi"], newrows, comm)

    # ---- d0: aggregated dense update (STAT_NORM mean)
    # (STAT_NORM: the shared statistics move by the mean of the blocks'
    # deltas, else by their sum)
    norm = g.stat_norm
    c0 = sh["d0_c"]
    if port:
        delta0 = torch.clamp(((target_i * 4096 - sh["d0_p"][None]) * onp_i
                              ).sum(dim=0).to(i32), -(1 << 20), 1 << 20)
        hits0 = onp_i.sum(dim=0).to(i32)
        if norm:
            delta0 = delta0 // torch.clamp(hits0, min=1)
            hits0 = torch.clamp(hits0, max=1)
        r16_0 = 655360 // (10 * c0 + 16)
        sh["d0_p"] = torch.clamp(
            sh["d0_p"] + ((torch.clamp(delta0, -32768, 32767) * r16_0)
                          >> 16), 1, 4095)
        sh["d0_c"] = torch.clamp(c0 + hits0, max=cap)
    else:
        r0 = 1.0 / (c0 + 1.6)
        delta0 = ((target - sh["d0_p"][None]) * on_path).sum(dim=0)
        hits0 = on_path.sum(dim=0)
        if norm:
            delta0 = delta0 / torch.clamp(hits0, min=1.0)
            hits0 = torch.clamp(hits0, max=1.0)
        sh["d0_p"] = torch.clamp(sh["d0_p"] + r0 * delta0, 1e-4, 1 - 1e-4)
        sh["d0_c"] = torch.clamp(c0 + hits0, max=float(cap))

    # ---- d1/d2/bracket arena
    newd = torch.where(
        onp_b[:, None, :],
        _slot_update_int(aux["d12rows"], target_i[:, None, :], cap) if port
        else _slot_update(aux["d12rows"], target[:, None, :], cap),
        aux["d12rows"])
    _set_rows(sh["d12"], aux["d12_idx"], newd, comm, "d12")

    # ---- PPM counts (update exclusion PPM_UPD, halve-on-overflow)
    ppm_rows = aux["ppm_rows"]
    obs = torch.gather(ppm_rows, 2, byte[:, None, None].expand(
        B, g.n_ppm, 1))                                      # (B, NP, 1)
    if g.ppm_upd:
        # update exclusion: bump only the orders at or above the highest
        # that already held the byte (all of them for a novel byte)
        seen = obs[:, :, 0] > 0
        rev = torch.flip(seen, [1]).long()
        above = (torch.cumsum(rev, dim=1) - rev) > 0
        upd = (~torch.flip(above, [1]))[:, :, None]
    else:
        upd = torch.ones_like(obs, dtype=torch.bool)
    needs_halve = (obs >= 256 - PPM_INC) & upd
    prow_new = torch.where(needs_halve, ppm_rows >> 1, ppm_rows)
    byte_oh = (node[None, :] == byte[:, None])[:, None, :]
    prow_new = prow_new + torch.where(byte_oh & upd, PPM_INC, 0)
    pw = prow_new.reshape(B, g.n_ppm, 64, 4).long()
    prow_new_w = to_bits(pw[..., 0] | (pw[..., 1] << 8) | (pw[..., 2] << 16)
                         | (pw[..., 3] << 24))
    p_ar = torch.arange(g.n_ppm, device=dev)[None, :]
    pflat = p_ar * cfg.prows + aux["prowi"]
    _set_rows(sh["ppm"].view(-1, 64), pflat, prow_new_w, comm, "ppm")
    if g.ppm_ck:
        _set_rows(sh["ppm_ck"].view(-1, 1), pflat, aux["pck_exp"][..., None])

    # ---- JVAL: bump the coded byte's count in each tier's row (halve the
    # row first when the count would overflow a byte); blocks off the
    # JPEG planes write nothing
    for key, rows, ctx in zip(("jval", "jval2"), aux["jrows"],
                              ("jctx", "jctx2")):
        obs_j = torch.gather(rows, 1, byte[:, None])
        jr = torch.where(obs_j >= 256 - 4, rows >> 1, rows)
        jr = jr + torch.where(node[None, :] == byte[:, None], 4, 0
                              ).to(torch.uint8)
        _set_rows_where(sh[key], aux["jx"][ctx], jr, aux["jx"]["jvalid"])

    # ---- SEE: escape estimates toward observed escape events
    obs_eff = torch.gather(aux["pcnt_eff"], 2, byte[:, None, None].expand(
        B, g.n_ppm, 1))[:, :, 0]
    see_flat = (p_ar * SEE_DIST_B + aux["see_d"]) * SEE_TOT_B + aux["see_t"]
    n_see = g.n_ppm * SEE_DIST_B * SEE_TOT_B
    if port:
        see_msk = (aux["ptot"] > 0).to(i32)
        d_see = ((((obs_eff == 0).to(i32) * 4096 - aux["see_p"]) * 82)
                 >> 12) * see_msk
        see_acc = _scatter_add(n_see, see_flat, d_see)
        if norm:
            see_acc = see_acc // torch.clamp(
                _scatter_add(n_see, see_flat, see_msk), min=1)
        sh["ppm_see"] = torch.clamp(
            sh["ppm_see"] + see_acc.view_as(sh["ppm_see"]), 4, 3891)
    else:
        see_msk = (aux["ptot"] > 0).float()
        d_see = SEE_RATE * ((obs_eff == 0).float() - aux["see_p"]) * see_msk
        see_acc = _scatter_add(n_see, see_flat, d_see)
        if norm:
            see_acc = see_acc / torch.clamp(
                _scatter_add(n_see, see_flat, see_msk), min=1.0)
        sh["ppm_see"] = torch.clamp(
            sh["ppm_see"] + see_acc.view_as(sh["ppm_see"]), 1e-3, 1.0 - 1e-3)

    # ---- state bank: advance the 8 path slots' automaton states
    NS = g.n_sbank
    s_ar = torch.arange(NS, device=dev)[None, :, None]
    srows = aux["srows"]
    s8 = torch.gather(srows, 2, n8[:, None, :].expand(B, NS, 8)).long() \
        & 0xFF                                               # (B, NS, 8)
    nxt01 = C.snext01[s_ar, s8]
    nxt8 = torch.where(t8[:, None, :] == 1, nxt01 >> 8, nxt01 & 0xFF)
    pm = sh["sbank_p"][s_ar, s8]
    sflat = s_ar * 256 + s8
    if port:
        d12s = (1311 * (t8_i[:, None, :] * 4096 - pm)) >> 16  # 0.02*65536
        sb_acc = _scatter_add(NS * 256, sflat, d12s)
        if norm:
            sb_acc = sb_acc // torch.clamp(_scatter_add(
                NS * 256, sflat, torch.ones_like(d12s)), min=1)
        sh["sbank_p"] = torch.clamp(sh["sbank_p"] + sb_acc.view(NS, 256),
                                    1, 4095)
        st13 = stretch13_lut(sh["sbank_p"][s_ar, nxt8])
    else:
        errs = t8[:, None, :] - pm
        rate = SBANK_RATE
        if g.sbank_adapt:
            # a state seen c times learns at max(SBANK_RATE, 1/(c+2))
            rate = torch.clamp(1.0 / (sh["sbank_c"] + 2.0), min=SBANK_RATE
                               )[s_ar, s8]
        sb_cnt = _scatter_add(NS * 256, sflat, torch.ones_like(errs))
        sb_acc = _scatter_add(NS * 256, sflat, rate * errs)
        if norm:
            sb_acc = sb_acc / torch.clamp(sb_cnt, min=1.0)
        sh["sbank_p"] = torch.clamp(sh["sbank_p"] + sb_acc.view(NS, 256),
                                    1e-4, 1 - 1e-4)
        if g.sbank_adapt:                # STAT_NORM: one visit per step
            seen_c = (sb_cnt > 0).float() if norm else sb_cnt
            sh["sbank_c"] = torch.clamp(
                sh["sbank_c"] + seen_c.view(NS, 256), max=1024.0)
        p_nxt = sh["sbank_p"][s_ar, nxt8]
        st13 = torch.clamp(_stretch_f(p_nxt) * 256.0 + 4096.0, 0, 8191
                           ).int()
    packed = nxt8.int() | (st13 << 8)
    new_srows = srows.scatter(2, n8[:, None, :].expand(B, NS, 8), packed)
    _set_rows(sh["sbank"].view(-1, 256),
              torch.arange(NS, device=dev)[None, :] * cfg.rows
              + aux["srowi"], new_srows, comm, "sbank")

    # ---- match / run confidences: dense one-hot aggregation
    def _mc_update(key, exp_bit, alive_m, conf, lenb):
        hit = (exp_bit.float() == target[:, None, :])
        wsum = alive_m.float() * on_path[:, None, :]
        n_alive = wsum.sum(dim=2)
        frac_hit = (hit * wsum).sum(dim=2) / torch.clamp(n_alive, min=1.0)
        derr = (frac_hit - conf) * 0.03 * torch.clamp(n_alive, max=1.0)
        oh_len = (C.ar32[None, None, :] == lenb[:, :, None]).float()
        d_mc = (oh_len * derr[:, :, None]).sum(dim=0)
        if norm:
            active = (derr.abs() > 0).float()
            n_mc = (oh_len * active[:, :, None]).sum(dim=0)
            d_mc = d_mc / torch.clamp(n_mc, min=1.0)
        sh[key] = torch.clamp(sh[key] + d_mc, 1e-3, 1 - 1e-3)

    def _mc_update_int(key, exp_bit, alive_m, conf, lenb):
        w_i = alive_m.to(i32) * onp_i[:, None, :]            # (B, NM, 256)
        n_al = w_i.sum(dim=2).to(i32)
        hits = ((exp_bit == target_i[:, None, :]).to(i32) * w_i
                ).sum(dim=2).to(i32)
        frac12 = (hits << 12) // torch.clamp(n_al, min=1)
        derr = (((frac12 - conf) * 123) >> 12) \
            * torch.clamp(n_al, max=1)                       # 0.03 * 4096
        oh_len = (C.ar32[None, None, :] == lenb[:, :, None]).to(i32)
        d_mc = (oh_len * derr[:, :, None]).sum(dim=0).to(i32)
        if norm:
            d_mc = d_mc // torch.clamp((oh_len * (derr != 0).to(i32)[
                :, :, None]).sum(dim=0).to(i32), min=1)
        sh[key] = torch.clamp(sh[key] + d_mc, 4, 4092)

    mc = _mc_update_int if port else _mc_update
    mc("match_conf", aux["exp_bit"], aux["alive"], aux["conf"], aux["lenb"])
    for key, m in (("match2_conf", aux["mt2"]), ("runx_conf", aux["rxd"])):
        if m is not None:
            mc(key, m["exp_bit"], m["alive"], m["conf"], m["lenb"])
    vmx = aux["vmx"]
    if vmx is not None:
        # VMATCH: the shared confidence per matched-prefix length (STAT_NORM:
        # the mean over the blocks whose line-above byte was alive)
        v_af = vmx["valive"].float()
        vderr = ((vmx["vexp"] == byte).float() - vmx["vconf"]) * 0.03 * v_af
        voh = (C.ar32[None, :] == vmx["vlml"][:, None]).float()
        d_vm = (voh * vderr[:, None]).sum(dim=0)
        if norm:
            d_vm = d_vm / torch.clamp((voh * v_af[:, None]).sum(dim=0),
                                      min=1.0)
        sh["vmatch_conf"] = torch.clamp(sh["vmatch_conf"] + d_vm, 1e-3,
                                        1 - 1e-3)
    lms = aux["lms"]
    if lms is not None:
        part(ROUTED)
        # the shared confidence per error bucket (STAT_NORM: the mean; at
        # LMS=2 only media blocks teach it)
        lderr = ((lms["pbyte"] == byte).float() - lms["conf"]) * 0.02
        if lms["med"] is not None:
            lderr = lderr * lms["med"].float()
        loh = (C.ar16[None, :] == lms["errb"][:, None]).float()
        d_lm = (loh * lderr[:, None]).sum(dim=0)
        if norm:
            d_lm = d_lm / torch.clamp(loh.sum(dim=0), min=1.0)
        sh["lms_conf"] = torch.clamp(sh["lms_conf"] + d_lm, 1e-3, 1 - 1e-3)
        part("update")
    if port:
        return _update_mixers_int(g, C, sh, aux, target_i, onp_i, n8, t8_i)

    # ---- mixers (MIX_NORM: per-row means over the blocks hitting a row,
    # else their sums)
    mnorm = g.mix_norm
    B_f = 1.0 / B if mnorm else 1.0

    def rows_mean(n, idx, d, at=None):
        # the mean of the blocks' deltas d at each row they hit, or
        # (MIX_NORM=0) the sum; at the rows ``at`` only, if given
        pick = _rows_at(at)
        acc = pick(_scatter_add(n, idx, d))
        if mnorm:
            cnt = pick(_scatter_add(n, idx, torch.ones(idx.shape,
                                                       device=dev)))
            acc = acc / torch.clamp(cnt.view((-1,) + (1,) * (d.dim()
                                                            - idx.dim())),
                                    min=1.0)
        return acc

    def rows_step(w, n, idx, d):
        # the gated rows' step
        return w + lr * rows_mean(n, idx, d)

    x = aux["x"]
    err1 = (target[:, None, :] - aux["p1"]) * on_path[:, None, :]
    dws = torch.bmm(err1, x.transpose(1, 2))                 # (B, M1, NIN)
    if g.bank_ch > 1:
        dws = dws * C.ch_scale[None, None, :]
    w1 = sh["w1"].clone()
    w1[0] = aux["w_const"] + lr * B_f * dws[:, 0].sum(dim=0)
    dl = torch.einsum("lk,bk,bnk->ln", C.lvl_onehot, err1[:, 1], x)
    w1[1:9] = aux["w_level"] + lr * B_f * dl
    if not mnorm and g.mix_boost:
        # MIX_BOOST: a row seen c times learns at lr (1 + MIX_BOOST N /
        # (c + N)), N = MIX_BOOST_N, the counts kept per row (w1_cnt)
        nb = g.mix_boost_n
        boost = 1.0 + g.mix_boost * nb / (sh["w1_cnt"][aux["dyn_idx"]] + nb)
        sh["w1"] = w1 + _scatter_add(g.mix1_total, aux["dyn_idx"],
                                     (lr * boost)[:, :, None] * dws[:, 2:])
        sh["w1_cnt"] = sh["w1_cnt"] + _scatter_add(
            g.mix1_total, aux["dyn_idx"],
            torch.ones(aux["dyn_idx"].shape, device=dev))
    else:
        # the gated rows step on the rows the blocks hit only (every other
        # row's step is w + lr * 0 = w): the table holds thousands of rows,
        # a block hits one of each gated set (_put_rows)
        f = aux["dyn_idx"].reshape(-1)
        sh["w1"] = _put_rows(w1, f, w1.index_select(0, f) + lr * rows_mean(
            g.mix1_total, aux["dyn_idx"], dws[:, 2:], f))
    sh["bias1"] = sh["bias1"] + lr * B_f * err1.sum(dim=0)

    st1 = aux["st1"]
    err2 = (target[:, None, :] - aux["p2"]) * on_path[:, None, :]
    dw2 = torch.einsum("lk,bk,bmk->lm", C.lvl_onehot, err2[:, 0], st1)
    sh["w2"] = sh["w2"] + lr * B_f * dw2
    dw2b = torch.bmm(st1, err2[:, 1, :, None])[:, :, 0]     # (B, M2)
    dw2c = torch.bmm(st1, err2[:, 2, :, None])[:, :, 0]
    ones = torch.ones(B, device=dev)
    sh["w2b"] = rows_step(sh["w2b"], 256, aux["b1"], dw2b)
    sh["w2c"] = rows_step(sh["w2c"], 64, aux["clsg"], dw2c)
    if g.mix2x:
        dw2x = torch.bmm(err2[:, 3:], st1.transpose(1, 2))   # (B, 5, M2)
        sh["w2x"] = rows_step(sh["w2x"], g.mix2_total, aux["dyn2_idx"], dw2x)
    sh["bias2"] = sh["bias2"] + lr * B_f * err2.sum(dim=0)

    err3 = (target - aux["p_mix"]) * on_path
    dw3 = torch.einsum("lk,bk,bjk->lj", C.lvl_onehot, err3, aux["st2"])
    sh["w3"] = sh["w3"] + lr * B_f * dw3
    sh["bias3"] = sh["bias3"] + lr * B_f * err3.sum(dim=0)

    # ---- APMs: in-row deltas at the 8 path nodes, one row scatter
    p_tree_p = torch.gather(aux["p_tree"], 1, n8)            # (B, 8)
    errp = (t8 - p_tree_p) * APM_RATE
    j33 = C.j33[None, None, :]

    def row_delta(tl, frac):
        tl_p = torch.gather(tl, 1, n8)
        f_p = torch.gather(frac, 1, n8)
        return ((j33 == tl_p[:, :, None]).float()
                * ((1 - f_p) * errp)[:, :, None]
                + (j33 == (tl_p + 1)[:, :, None]).float()
                * (f_p * errp)[:, :, None]).sum(dim=1)

    # the parallel rows are read at one (tl, frac): one in-row delta; the
    # SSE2 row at its own
    newapm = torch.clamp(aux["apm_rows"] + row_delta(
        aux["apm_tl"], aux["apm_frac"])[:, None], 1e-4, 1 - 1e-4)
    apm_idx = aux["apm_idx"]
    sse2 = aux["sse2"]
    if sse2 is not None:
        new2 = torch.clamp(sse2["rows"] + row_delta(sse2["tl"], sse2["frac"]),
                           1e-4, 1 - 1e-4)
        newapm = torch.cat([newapm, new2[:, None]], dim=1)
        apm_idx = torch.cat([apm_idx, g.sse2_base + sse2["g"][:, None]], 1)
    _set_rows(sh["apm"], apm_idx, newapm)

    # ---- final blend weights (match-state gated, count-normalized;
    # W_APM_LEARN=0 keeps them at their start)
    err_f = (target - aux["p_tree"]) * on_path
    if g.w_apm_learn:
        dwa = torch.bmm(aux["st_in"], err_f[:, :, None])[:, :, 0]
        cnt = _scatter_add(64, aux["longest"], ones)
        acc = _scatter_add(64, aux["longest"], dwa)
        sh["w_apm"] = torch.clamp(
            sh["w_apm"] + lr * acc / torch.clamp(cnt[:, None], min=1.0),
            -4.0, 4.0)
    if sse2 is not None:
        # the SSE2 stage's mixer, the mean over the blocks of each gate
        ds = torch.stack([(err_f * sse2["stf"]).sum(dim=1),
                          (err_f * sse2["stp"]).sum(dim=1)], dim=1)
        cnt_s = _scatter_add(256, sse2["g"], ones)
        acc_s = _scatter_add(256, sse2["g"], ds)
        sh["w_sse"] = torch.clamp(
            sh["w_sse"] + lr * acc_s / torch.clamp(cnt_s[:, None], min=1.0),
            -4.0, 4.0)
    return sh


def _update_mixers_int(g, C, sh, aux, target_i, onp_i, n8, t8_i):
    """Integer mixer, APM and final-blend updates (portable profile; JAX
    engine _update_mixers_int).  Errors are p12, inputs st256; deltas land
    in 16-bit-fraction weights as (lr12 * ((err*x) >> 8)) >> 8, every
    batch aggregation is an integer sum or scatter-add (exact in any
    order), the MIX_NORM means floor divisions, and weights clip to
    +-8*65536 (the _idot bound)."""
    i32 = torch.int32
    lr12 = max(1, int(round(g.mix_lr * 4096)))
    B = target_i.shape[0]
    mnorm = g.mix_norm
    # MIX_NORM: the batch means of the const, level and bias deltas and the
    # per-row means of the gated rows' (floor divisions), else their sums
    mean_b = (lambda v: v // B) if mnorm else (lambda v: v)    # noqa: E731
    wclip = 8 * 65536
    x = aux["x"]
    sum_b = lambda v: v.sum(dim=0).to(i32)                    # noqa: E731

    def lvl_sum(e, y):
        # sum_k [level(k) == l] e[b, k] y[b, n, k], each (l, b) >> 8, then
        # the batch mean: (8, N)
        d = ieinsum("lk,bk,bnk->lbn", C.lvl_i, e, y) >> 8
        return mean_b(d.sum(dim=1).to(i32))

    def rows_mean(n, idx, d, norm=True, at=None):
        # at the rows ``at`` only, if given
        pick = _rows_at(at)
        acc = pick(_scatter_add(n, idx, d))
        if not norm:
            return acc
        cnt = pick(_scatter_add(n, idx, torch.ones(idx.shape, dtype=i32,
                                                   device=idx.device)))
        return acc // torch.clamp(cnt, min=1).view((-1,) + (1,) * (d.dim()
                                                                 - idx.dim()))

    def step(w, d, clip=wclip):
        return torch.clamp(w + ((lr12 * d) >> 8), -clip, clip)

    # ---- layer 1: constant row, level rows, gated rows, biases
    err1 = (target_i[:, None, :] * 4096 - aux["p1"]) * onp_i[:, None, :]
    dws8 = ieinsum("bmk,bnk->bmn", err1, x) >> 8             # (B, M1, NIN)
    n_pri = g.n_primary
    dws8 = torch.cat([dws8[:, :, :n_pri], dws8[:, :, n_pri:] >> 2], dim=2)
    w1 = sh["w1"].clone()
    w1[0] = step(aux["w_const"], mean_b(sum_b(dws8[:, 0])))
    w1[1:9] = step(aux["w_level"], lvl_sum(err1[:, 1], x))
    # the gated rows step on the rows the blocks hit only (every other
    # row's delta is 0 and its |w| <= wclip, so it keeps its value): the
    # table holds thousands of rows, a block hits one of each gated set
    # (_put_rows)
    f = aux["dyn_idx"].reshape(-1)
    sh["w1"] = _put_rows(w1, f, step(w1.index_select(0, f), rows_mean(
        g.mix1_total, aux["dyn_idx"], dws8[:, 2:], mnorm, f)))
    sh["bias1"] = sh["bias1"] + ((lr12 * mean_b(sum_b(err1))) >> 8)

    # ---- layer 2: level rows, byte- and class-gated rows, gated rows
    st1 = aux["st1"]
    err2 = (target_i[:, None, :] * 4096 - aux["p2"]) * onp_i[:, None, :]
    sh["w2"] = step(sh["w2"], lvl_sum(err2[:, 0], st1))
    for key, idx, n, j in (("w2b", aux["b1"], 256, 1),
                           ("w2c", aux["clsg"], 64, 2)):
        d = ieinsum("bk,bmk->bm", err2[:, j], st1) >> 8
        sh[key] = step(sh[key], rows_mean(n, idx, d, mnorm))
    if g.mix2x:
        d2x = ieinsum("bjk,bmk->bjm", err2[:, 3:], st1) >> 8
        sh["w2x"] = step(sh["w2x"], rows_mean(g.mix2_total, aux["dyn2_idx"],
                                              d2x, mnorm))
    sh["bias2"] = sh["bias2"] + ((lr12 * mean_b(sum_b(err2))) >> 8)

    # ---- layer 3
    err3 = (target_i * 4096 - aux["p_mix"]) * onp_i
    sh["w3"] = step(sh["w3"], lvl_sum(err3, aux["st2"]))
    sh["bias3"] = sh["bias3"] + ((lr12 * mean_b(sum_b(err3))) >> 8)

    # ---- APMs: integer deltas at the 8 path nodes, scatter-add, clip
    errp = (((t8_i * 4096 - torch.gather(aux["p_tree12"], 1, n8)) * 82)
            >> 12)                                           # 0.02 * 4096
    j33 = C.j33[None, None, :]

    def row_delta(tl, frac):
        tl_p = torch.gather(tl, 1, n8)
        f_p = torch.gather(frac, 1, n8)
        return ((j33 == tl_p[:, :, None]).to(i32)
                * (((128 - f_p) * errp) >> 7)[:, :, None]
                + (j33 == (tl_p + 1)[:, :, None]).to(i32)
                * ((f_p * errp) >> 7)[:, :, None]).sum(dim=1).to(i32)

    # the parallel rows are read at one (tl, frac): one in-row delta; the
    # SSE2 row at its own
    d_apm = row_delta(aux["apm_tl"], aux["apm_frac"])[:, None].expand(
        -1, g.n_apm, -1)
    apm_idx = aux["apm_idx"]
    sse2 = aux["sse2"]
    if sse2 is not None:
        d_apm = torch.cat([d_apm, row_delta(sse2["tl"], sse2["frac"])
                           [:, None]], dim=1)
        apm_idx = torch.cat([apm_idx, g.sse2_base + sse2["g"][:, None]], 1)
    sh["apm"] = torch.clamp(sh["apm"] + _scatter_add(g.apm_rows, apm_idx,
                                                     d_apm), 1, 4095)

    # ---- final blend weights (match-state gated, count-normalized)
    err_f = (target_i * 4096 - aux["p_tree12"]) * onp_i
    if g.w_apm_learn:
        dwa = ieinsum("bk,bjk->bj", err_f, aux["st_in"]) >> 8
        sh["w_apm"] = step(sh["w_apm"], rows_mean(64, aux["longest"], dwa),
                           clip=262144)
    if sse2 is not None:
        # the SSE2 stage's mixer (|sum| < 8 * 4096 * 3072 per block)
        ds = torch.stack([ieinsum("bk,bk->b", err_f, sse2["stf"]),
                          ieinsum("bk,bk->b", err_f, sse2["stp"])], 1) >> 8
        sh["w_sse"] = step(sh["w_sse"], rows_mean(256, sse2["g"], ds),
                           clip=262144)
    return sh


def _aux_writes_b(cfg, g, sh, pb, byte, t, ind_key_prev, ind_prev_val,
                  comm=None):
    """Match-cursor repositioning + match/indirect table writes, one
    scatter on the shared aux arena.  In a sharded step (``comm``) the
    lanes are the rank's, numbered from ``comm.lane0``: the arena's
    writes are every lane's, and cursors read every lane's history."""
    cs = pb["ctx"]
    B = byte.shape[0]
    dev = byte.device
    bar = torch.arange(B, device=dev)
    hist, nlanes = pb["hist"], B
    if comm is not None:
        bar = bar + comm.lane0
        hist, nlanes = comm.hist, comm.n_lanes
    keys = []
    for o in g.match_orders:
        if o == 100:
            keys.append(mix32(cs["last_word"], (cs["word"] + 0x9E37) & M32))
        elif o == 101:
            keys.append(mix32(mix32(cs["last_word2"], cs["last_word"]),
                              (cs["word"] + 0x85EB) & M32))
        else:
            # an order past the hashes reads as the JAX package's indexing
            # reads it: a negative one counts from the end, then it clamps
            n = cs["ohash"].shape[1]
            keys.append(cs["ohash"][:, min(max(o + n if o < 0 else o, 0),
                                          n - 1)])
    h = mix32(torch.stack(keys, dim=1), 0x2545F491) & ((1 << cfg.mbits) - 1)
    ms = g.mstride                  # MATCH2: a 2-deep recency stack per key
    moff = torch.arange(g.n_match, device=dev) * (ms << cfg.mbits)
    midx = moff[None, :] + ms * h                            # (B, NM)
    aux_tbl = sh["aux_tbl"]
    cand = _rows(sh, "aux_tbl", midx, comm=comm).long()      # int32 view
    ins = ((bar[:, None] << POS_BITS) | (t + 1)).expand(B, g.n_match)
    ind_base = ms * g.n_match * (1 << cfg.mbits)
    ind_off = ind_base + torch.arange(g.n_ind, device=dev) * (1 << cfg.ibits)
    newv = mix32(ind_prev_val, byte[:, None])
    ind_idx = ind_off[None, :] + ind_key_prev
    if g.match2:
        # the recency shift: slot 1 takes the old latest, slot 0 the new
        cand2 = _rows(sh, "aux_tbl", midx + 1, comm=comm).long()
        widx = torch.cat([midx, midx + 1, ind_idx], 1)
        wval = torch.cat([to_bits(ins), cand.to(torch.int32),
                          to_bits(newv)], 1)
    else:
        widx = torch.cat([midx, ind_idx], 1)
        wval = torch.cat([to_bits(ins), to_bits(newv)], 1)
    if comm is not None:
        widx, wval = comm.lanes((widx, wval))
    _set_rows(aux_tbl.view(-1, 1), widx, wval[..., None], comm, "aux_tbl")

    def _advance(blk_k, pos_k, len_k, c):
        blk = pb[blk_k]
        pred = hist[torch.where(blk < 0, blk + nlanes, blk),
                    torch.clamp(pb[pos_k], 0, cfg.block_size - 1)].long()
        ok = (pb[len_k] > 0) & (pred == byte[:, None])
        c_pos = c & ((1 << POS_BITS) - 1)
        pb[blk_k] = torch.where(ok, blk, c >> POS_BITS)
        pb[pos_k] = torch.where(ok, pb[pos_k] + 1, c_pos)
        pb[len_k] = torch.where(ok, torch.clamp(pb[len_k] + 1, max=65535),
                                (c_pos > 0).long())

    _advance("mp_blk", "mp_pos", "match_len", cand)
    if g.match2:
        _advance("mp2_blk", "mp2_pos", "match2_len", cand2)
    return sh, pb


# ---------------------------------------------------------------- byte step

# the aux entries a sharded step does not all-gather: the shared layer-1
# rows (not per lane) and the DMC walk (the rank's own plan step reads it)
_AUX_NOT_LANES = ("w_const", "w_level", "dmc_walk")


def make_byte_step(cfg: EngineConfig, g: Gates, device, comm=None,
                   part=None):
    """-> byte_step(sh, pb, cd, comp, inp_byte_b, t, mode) returning
    (sh, pb, cd, e32 (B, 8), c32 (B,)).  State dicts are updated in
    place where that saves a copy (some leaves in place, others rebound to
    new tensors).  t is the byte index in the block, a 0-d int64 tensor on
    ``device`` (0 <= t < block_size): nothing in the step reads a value
    back to the host, so a CUDA graph can capture it
    (``make_segment_fn``).

    ``comm`` (``parallel/mesh.py``) makes it one rank's step of a dp x tp
    mesh: the lanes are the rank's, the tp tables its slices.  It predicts
    and codes its lanes; the shared updates (``_update_tree_b`` and the
    LSTM's) run on every lane's all-gathered inputs, so each replica gets
    the unsharded step's update; the arena's writes are all-gathered too.
    Without ``comm`` the step is the unsharded one, operator for
    operator.

    ``part`` (``_PartTimer``): called with a part's name (``PARTS``) where
    the coder, update, state and lstm parts begin; the step's caller marks
    predict's start and copyback's.  With GRID2, JPEGX or LMS on, the
    routed work is marked ``ROUTED`` where it begins and the enclosing
    part's name where that resumes: the record grid's contexts and the
    LMS's prediction in ``predict``, the LMS's updates in ``update``."""
    C = _Consts(g, device)
    part = part or _no_part
    imask = (1 << cfg.ibits) - 1
    lcfg = _lstm_cfg(cfg, g)
    lstm_update = (ilstm_shared_byte_update if g.port
                   else lstm_shared_byte_update)
    if cfg.dmc_nodes and g.dmc_levels < 1:
        raise FormatError(f"DMC_LEVELS={g.dmc_levels}: the DMC walk needs a "
                          "depth of 1..8 (0 disables DMC: dmc_nodes=0)")
    ind_off = g.mstride * g.n_match * (1 << cfg.mbits) + torch.arange(
        g.n_ind, device=device) * (1 << cfg.ibits)

    def ind_keys(cs):
        l4 = cs["last4"]
        ks = [l4 & imask, l4 & 0xFF, cs["ohash"][:, 3] & imask,
              cs["word"] & imask, cs["ohash"][:, 2] & imask,
              cs["ohash"][:, 4] & imask, cs["clsreg"] & imask,
              ((l4 >> 8) & 0xFFFF) & imask]
        return torch.stack(ks[:g.n_ind], dim=1)

    def byte_step(sh, pb, cd, comp, inp_byte_b, t, mode):
        B = inp_byte_b.shape[0]
        ind_key_prev = ind_keys(pb["ctx"])
        ind_prev_val = _rows(sh, "aux_tbl", ind_off[None, :] + ind_key_prev,
                             comm=comm).long() & M32

        p_tree, aux = _predict_tree_b(cfg, g, C, sh, pb, t, comm, part)
        if g.port:
            p16_tree = p_tree.long()         # already p16, clipped
        else:
            p16_tree = torch.clamp((p_tree * 65536.0).long(), 64, 65472)
        vf = sh["vocab_force"][None, :]
        p16_tree = torch.where(vf == 1, 64,
                               torch.where(vf == 2, 65472, p16_tree))

        # ---- the only sequential part: 8 coder steps down the tree
        part("coder")
        byte_acc = torch.ones(B, dtype=torch.int64, device=device)
        inp = inp_byte_b.long()
        emits = []
        c32 = torch.zeros(B, dtype=torch.int64, device=device)
        for k in range(8):
            p16 = torch.gather(p16_tree, 1, byte_acc[:, None])[:, 0]
            enc_bit = (inp >> (7 - k)) & 1
            cd, bit, e32, kk = _coder_bit_b(cd, comp, enc_bit, p16, mode)
            emits.append(e32)
            c32 = c32 | (kk << (4 * k))
            byte_acc = byte_acc * 2 + bit
        byte = byte_acc & 255

        part("update")
        if comm is None:
            sh = _update_tree_b(cfg, g, C, sh, aux, byte, t, part=part)
        else:
            lanes, byte_all, lstm_all = comm.lanes((
                {k: v for k, v in aux.items() if k not in _AUX_NOT_LANES},
                byte, pb.get("lstm")))
            sh = _update_tree_b(cfg, g, C, sh, dict(
                lanes, w_const=aux["w_const"], w_level=aux["w_level"]),
                byte_all, t, comm, part)
        lms = aux["lms"]
        if lms is not None:                  # the block's own taps
            part(ROUTED)
            lerr = (byte.float() - 128.0) * (1.0 / 128.0) - lms["pred"]
            pb["lms_w"] = pb["lms_w"] + LMS_MU * lerr[:, None] * lms["xs"]
            pb["lms_err"] = 0.98 * pb["lms_err"] + 0.02 * lerr.abs()
        part("state")
        pb["hist"].index_copy_(1, t.view(1), byte.to(torch.uint8)[:, None])
        if comm is not None:
            comm.hist.index_copy_(1, t.view(1),
                                  byte_all.to(torch.uint8)[:, None])
        if g.ppm_deep:
            A = 0x01000193
            for key, w in (("h32", 32), ("h48", 48)):
                old = pb["hist"].index_select(
                    1, ((t - w) % cfg.block_size).view(1))[:, 0].long()
                pb[key] = (mul((pb[key] - mul(old, pow(A, w - 1, 1 << 32)))
                               & M32, A) + byte) & M32
        if cfg.dmc_nodes:
            pb.update(dmc.plan_step({k: pb[k] for k in dmc.DMC_KEYS},
                                    aux["dmc_walk"], byte, g.dmc_levels))

        # ---- record-length voting
        lp = torch.gather(pb["rec_lastpos"], 1, byte[:, None])[:, 0]
        stv = torch.gather(pb["rec_stride"], 1, byte[:, None])[:, 0]
        gap = t - lp
        cand = (lp >= 0) & (gap >= 2) & (gap < 4096) & (gap == stv)
        same = cand & (gap == pb["rec_len"])
        rcnt = torch.where(same, torch.clamp(pb["rec_cnt"] + 1, max=63),
                           torch.where(cand, pb["rec_cnt"] - 1,
                                       pb["rec_cnt"]))
        switch = cand & ~same & (rcnt < 0)
        pb["rec_len"] = torch.where(switch, gap, pb["rec_len"])
        pb["rec_cnt"] = torch.where(switch, 0, rcnt)
        pb["rec_stride"] = pb["rec_stride"].scatter(1, byte[:, None],
                                                    gap[:, None])
        pb["rec_lastpos"] = pb["rec_lastpos"].scatter(
            1, byte[:, None], t.expand(B, 1))

        pb["ctx"] = update_ctx_state_batched(
            pb["ctx"], byte, g.wrtw,
            (sh["wrtw_word"], sh["wrtw_stem"]) if g.wrtw >= 2 else None)
        pb["x86"] = x86_update(pb["x86"], byte)
        sh, pb = _aux_writes_b(cfg, g, sh, pb, byte, t, ind_key_prev,
                               ind_prev_val, comm)
        pb["ind_val"] = _rows(sh, "aux_tbl", ind_off[None, :]
                              + ind_keys(pb["ctx"]), comm=comm).long() & M32
        part("lstm")
        if cfg.lstm_hidden and comm is None:
            sh["lstm"], pb["lstm"] = lstm_update(lcfg, sh["lstm"],
                                                 pb["lstm"], byte)
        elif cfg.lstm_hidden:
            sh["lstm"], lstm_all = lstm_update(lcfg, sh["lstm"], lstm_all,
                                               byte_all)
            pb["lstm"] = comm.own_lanes(lstm_all)
        return sh, pb, cd, torch.stack(emits, dim=1), c32

    return byte_step


# ------------------------------------------------------------ segment loop

# the byte step's parts, in the order they run (PERF.md §3): the tree's
# prediction, the 8 coder steps, the shared tables' update, the per-lane
# state, the LSTM's update, and the static step's copy-back and row writes
PARTS = ("predict", "coder", "update", "state", "lstm", "copyback")
# the content-routed work's part, marked only where GRID2, JPEGX or LMS is
# on (``make_byte_step``): its device ms are taken out of the parts above
ROUTED = "routed"


def _no_part(name):
    """A part mark where nothing times the step's parts."""


class _PartTimer:
    """The step's part marks as timing events in its CUDA graph: while
    ``armed`` (the capture) each mark records an external timing event,
    which the graph keeps as an event node and re-records on every
    replay; ``None`` marks the end of the last part.  ``ms()`` reads the
    parts of the last replay (the stream idle), a part marked more than
    once summed over its stretches."""

    def __init__(self):
        self.armed = False
        self.marks = []

    def __call__(self, name):
        if self.armed:
            ev = torch.cuda.Event(enable_timing=True, external=True)
            ev.record()
            self.marks.append((name, ev))

    def ms(self):
        """{part: device ms} of the last replay."""
        out = {}
        for a, b in zip(self.marks, self.marks[1:]):
            out[a[0]] = out.get(a[0], 0.0) + a[1].elapsed_time(b[1])
        return out


def _tree_copy(tree):
    """The dict structure of ``tree`` copied; its tensors shared."""
    return {k: _tree_copy(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _tree_leaves(tree):
    return [x for v in tree.values()
            for x in (_tree_leaves(v) if isinstance(v, dict) else [v])]


def _storage(x):
    return x.untyped_storage().data_ptr()


def _rebound(static, new, path=""):
    """[(static leaf, new leaf)] of every leaf the step rebound to another
    tensor; raises if the step changed the tree's keys."""
    if static.keys() != new.keys():
        raise RuntimeError(f"the byte step changed the state's keys at "
                           f"{path or 'the root'}: "
                           f"{sorted(set(static) ^ set(new))}")
    out = []
    for k, s in static.items():
        n = new[k]
        if isinstance(s, dict):
            out += _rebound(s, n, f"{path}{k}.")
        elif n is not s:
            out.append((s, n))
    return out


def make_static_step(cfg: EngineConfig, g: Gates, device, comm=None,
                     part=None):
    """-> body(st): one byte step on static buffers, the callable a CUDA
    graph captures (the JAX package's scan body); with ``comm`` a sharded
    rank's step (``make_byte_step``), whose every-lane history
    ``comm.hist`` is static per group width; ``part`` marks the step's
    parts (``PARTS``, ``_PartTimer``).

    ``st`` holds the state trees ``sh``, ``pb``, ``cd``, the group's
    ``comp`` (B, C) uint8 and ``mode`` (B,), the segment's input rows
    ``inp`` (S, B) uint8, its outputs ``e32`` (S, B, 8) and ``c32`` (S, B)
    int64 and ``t``, the 0-d int64 byte index.  The body runs the byte
    step at row t mod S on structural copies of the trees, copies every
    leaf the step rebound back into its static leaf, writes the row's
    outputs and advances t modulo the block, so every tensor of ``st``
    keeps its storage from step to step."""
    part = part or _no_part
    step = make_byte_step(cfg, g, device, comm, part)
    row_mask, t_mask = cfg.seg_size - 1, cfg.block_size - 1

    def body(st):
        part("predict")
        t = st["t"]
        row = (t & row_mask).view(1)
        trees = {k: _tree_copy(st[k]) for k in ("sh", "pb", "cd")}
        sh, pb, cd, e32, c32 = step(
            trees["sh"], trees["pb"], trees["cd"], st["comp"],
            st["inp"].index_select(0, row)[0], t, st["mode"])
        part("copyback")
        pairs = (_rebound(st["sh"], sh) + _rebound(st["pb"], pb)
                 + _rebound(st["cd"], cd))
        # a new leaf that lies in a static leaf's storage is read before
        # any static leaf is written
        static = {_storage(x) for x in _tree_leaves(st)}
        news = [n.clone() if _storage(n) in static else n for _, n in pairs]
        for (s, _), n in zip(pairs, news):
            s.copy_(n)
        st["e32"].index_copy_(0, row, e32[None])
        st["c32"].index_copy_(0, row, c32[None])
        t.copy_((t + 1) & t_mask)
        part(None)

    return body


class _Segments:
    """A coding group's segments, run the JAX package's way: one compiled
    program replayed.  On CUDA (``graph``) the byte step over static
    buffers (``make_static_step``) is captured once into a
    ``torch.cuda.CUDAGraph`` and replayed seg_size times per segment; a
    later group of the same width copies its state into the buffers.
    Elsewhere, or with ``graph=False``, the eager step runs in a Python
    loop with a device t.  A sharded rank's step (``comm``) runs either
    way, its collectives inside the graph.

    ``timed`` (the graph only): a timing event on the stream before a
    segment's first replay and one after each replay, from two rings of
    seg_size + 1 events that alternate between segments (``ring``: the
    last segment's; ``replay_ms``), and the step's parts as event nodes
    in the graph (``timer``: a ``_PartTimer``)."""

    def __init__(self, cfg: EngineConfig, g: Gates, device, graph,
                 comm=None, timed=False):
        self.cfg, self.device, self.comm = cfg, device, comm
        self.graph = graph and device.type == "cuda"
        self.timer = _PartTimer() if timed and self.graph else None
        self._rings = [[torch.cuda.Event(enable_timing=True)
                        for _ in range(cfg.seg_size + 1)]
                       for _ in range(2)] if self.timer else None
        self.ring = None
        if self.graph:
            self.body = make_static_step(cfg, g, device, comm, self.timer)
        else:
            self.step = make_byte_step(cfg, g, device, comm)
            self.ts = torch.arange(cfg.block_size, device=device)
        self.st = self._g = None
        self.per_replay = None          # kernel launches one replay makes
        self.comm_per_replay = None     # comm.counts one replay adds

    @property
    def ready(self):
        """Whether ``start`` is past its set-up (the graph captured)."""
        return self.st is not None

    def start(self, sh, pb, cd, comp, mode):
        """A group begins at byte 0 from this state.  The graph's first
        group lends its tensors to the static buffers and is captured
        (warm-up and capture); a later group is copied in."""
        if not self.graph:
            self.st = dict(sh=sh, pb=pb, cd=cd, comp=comp, mode=mode, t=0)
            return
        new = dict(sh=sh, pb=pb, cd=cd, comp=comp, mode=mode)
        if self._g is None:
            S, B = self.cfg.seg_size, comp.shape[0]
            self.st = dict(
                {k: _tree_copy(v) if isinstance(v, dict) else v
                 for k, v in new.items()},
                inp=torch.zeros((S, B), dtype=torch.uint8, device=self.device),
                e32=torch.zeros((S, B, 8), dtype=torch.int64,
                                device=self.device),
                c32=torch.zeros((S, B), dtype=torch.int64, device=self.device),
                t=torch.zeros((), dtype=torch.int64, device=self.device))
            self._capture()
            return
        for k, v in new.items():
            pairs = (_rebound(self.st[k], v) if isinstance(v, dict)
                     else [(self.st[k], v)])
            for s, n in pairs:
                if s.shape != n.shape:
                    raise ValueError(f"group state {k}: {tuple(n.shape)} "
                                     f"where the graph has {tuple(s.shape)}")
                s.copy_(n)
        self.st["t"].zero_()

    def _capture(self):
        """Warm up on copies of the state (on a side stream, as the CUDA
        graphs notes ask; the first run fills the lazy device tables and
        loads the kernel library, the second must not synchronise with the
        host: an operator that does raises, naming itself), then capture
        one step on the static buffers.  The capture runs nothing: the
        state is as the group handed it in (a sharded rank's history,
        which the warm-up writes, is put back).  The kernel launches and
        the ``comm`` counts of the warm-up (on copies) and of the capture
        are taken back out of the counts; each replay adds what the
        capture recorded."""
        from cmix_tpu_torch.utils.checkpoint import clone_state
        dev, comm = self.device, self.comm
        before = dmc.launch_counts()
        if comm is not None:
            hist, counts = comm.hist.clone(), dict(comm.counts)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for strict in (False, True):
                warm = clone_state(self.st)
                prev = torch.cuda.get_sync_debug_mode()
                if strict:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    self.body(warm)
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
                del warm
        torch.cuda.current_stream(dev).wait_stream(side)
        warmed = dmc.launch_counts()
        if comm is not None:
            comm.hist.copy_(hist)
            warm_counts = dict(comm.counts)
        self._g = torch.cuda.CUDAGraph()
        if self.timer:
            self.timer.marks, self.timer.armed = [], True
        # thread-local: another thread's CUDA calls (a process group's
        # watchdog querying the warm-up's collectives) stay legal while
        # this thread captures
        try:
            with torch.cuda.graph(self._g,
                                  capture_error_mode="thread_local"):
                self.body(self.st)
        finally:
            if self.timer:
                self.timer.armed = False
        now = dmc.launch_counts()
        self.per_replay = [a - b for a, b in zip(now, warmed)]
        dmc.add_launches([a - b for a, b in zip(now, before)], -1)
        if comm is not None:
            self.comm_per_replay = {k: v - warm_counts[k]
                                    for k, v in comm.counts.items()}
            comm.counts.update(counts)

    def run(self, inp_seg, outputs=True):
        """Enqueue one segment on its input rows ``inp_seg`` (S, B) uint8
        -> (e32 (S, B, 8), c32 (S, B)) int64 on the device (the graph's
        static buffers: read them before the next ``run``), or None
        without ``outputs`` (the eager loop then keeps none)."""
        S = self.cfg.seg_size
        if self.graph:
            self.st["inp"].copy_(inp_seg)
            if self._rings is None:
                for _ in range(S):
                    self._g.replay()
            else:
                self._rings.reverse()
                self.ring = self._rings[0]
                self.ring[0].record()
                for ev in self.ring[1:]:
                    self._g.replay()
                    ev.record()
            dmc.add_launches(self.per_replay, S)
            if self.comm is not None:
                for k, v in self.comm_per_replay.items():
                    self.comm.counts[k] += v * S
            return (self.st["e32"], self.st["c32"]) if outputs else None
        st = self.st
        sh, pb, cd, t = st["sh"], st["pb"], st["cd"], st["t"]
        e32s, c32s = [], []
        for s in range(S):
            sh, pb, cd, e32, c32 = self.step(sh, pb, cd, st["comp"],
                                             inp_seg[s], self.ts[t],
                                             st["mode"])
            t = (t + 1) % self.cfg.block_size
            if outputs:
                e32s.append(e32)
                c32s.append(c32)
        st.update(sh=sh, pb=pb, cd=cd, t=t)
        return (torch.stack(e32s), torch.stack(c32s)) if outputs else None

    def state(self):
        """(sh, pb, cd) after the segments run so far."""
        return self.st["sh"], self.st["pb"], self.st["cd"]

    @staticmethod
    def replay_ms(ring):
        """Device ms of each replay of a segment run with ``ring`` (its
        events complete): every replay follows the last on the stream,
        so each interval is one replay's own time."""
        return [a.elapsed_time(b) for a, b in zip(ring, ring[1:])]


def make_segment_fn(cfg: EngineConfig, g: Gates, device, graph=True,
                    comm=None, timed=False):
    """The port's ``jax.jit`` of the JAX package's segment scan: an object
    whose ``start(sh, pb, cd, comp, mode)`` begins a coding group and whose
    ``run(inp_seg)`` enqueues one segment of seg_size byte steps on its
    time-major (S, B) uint8 input rows and returns (e32 (S, B, 8), c32
    (S, B)).  On CUDA one byte step is captured as a CUDA graph and
    replayed (a failed capture raises: there is no fallback); the eager
    step runs there only when asked (``graph=False``), and always on the
    CPU.  ``comm`` makes it a sharded rank's (``make_byte_step``): its
    collectives are captured with the step under NCCL or without a process
    group; Gloo's cannot be, and a graph asked for there raises
    ValueError.  ``timed`` times each replay and the step's parts on the
    device (``_Segments``)."""
    _check_capturable(graph, comm)
    return _Segments(cfg, g, device, graph, comm, timed)


def _check_capturable(graph, comm):
    if graph and comm is not None and not comm.capturable:
        raise ValueError("a Gloo rank's collectives cannot be captured in a "
                         "CUDA graph: run its step eagerly (graph=False)")


def make_seg_compactor(cfg: EngineConfig):
    """``(e32 (S, B, 8), c32 (S, B)) -> (seg_out (B, seg_cap) u8, seg_len)``:
    one segment's packed emission words as per-block contiguous bytes
    (host-side numpy)."""

    def compact(e32, c32):
        e32 = np.asarray(e32, dtype=np.int64)
        c32 = np.asarray(c32, dtype=np.int64)
        s, b = c32.shape
        cnts = (c32[:, :, None] >> (4 * np.arange(8))[None, None, :]) & 0xF
        cnts_t = cnts.transpose(1, 0, 2).reshape(b, s * 8)
        e_t = e32.transpose(1, 0, 2).reshape(b, s * 8)
        j = np.arange(4)
        vals = ((e_t[:, :, None] >> (24 - 8 * j)[None, None, :]) & 0xFF
                ).astype(np.uint8)
        valid = j[None, None, :] < cnts_t[:, :, None]
        seg_len = cnts_t.sum(axis=1)
        out = np.zeros((b, cfg.seg_cap), dtype=np.uint8)
        for i in range(b):
            body = vals[i][valid[i]]
            out[i, :len(body)] = body
        return out, seg_len

    return compact


# --------------------------------------------------------------- transcoder


def make_transcoder(cfg: EngineConfig, g: Gates, device, graph=True,
                    comm=None):
    """``transcode(sh, pb, inp, comp, mode, meter=None, progress=None)
    -> (hist, out, out_len)`` as numpy arrays.

    encode: inp (B, N) uint8 padded blocks, comp zeros -> compressed.
    decode: comp (B, comp_size) streams, inp zeros -> hist are the bytes.
    mode: scalar or per-lane (B,) -- a decode group mirrors its encode
    group, with raw-stored and padding lanes re-fed in encode mode.

    The segments run through ``make_segment_fn`` (on CUDA a captured graph
    per group width, kept across groups; ``graph=False`` asks for the eager
    step) in the JAX package's one-segment pipeline: segment si+1 is
    enqueued before the host compacts segment si, whose outputs a
    non-blocking copy into pinned memory, ordered on the stream before
    si+1 overwrites them, brings to the host.  meter: a
    ``utils.profiling.Meter`` (phases ``compile``: the graph's warm-up
    and capture, at the first group of a width; ``device``: the segments,
    a later group's copy into the graph, and the waits on the device;
    ``host``: the compaction; the spans ``transcode`` and its children,
    and with the graph each replay's device ms and the group's last
    replay's parts, from a segment function built ``timed``: see
    ``utils/profiling.py``); progress: a callable of the bytes done.
    ``comm``: a sharded rank's (``parallel/mesh.py``; its lanes, through
    the graph under NCCL or without a process group, eagerly under Gloo,
    where ``graph`` raises ValueError).  ``transcode.state()`` is (sh, pb,
    cd) after the last group: the graph's buffers, which hold a later
    group's state where the arrays handed in keep theirs."""
    _check_capturable(graph, comm)
    compact = make_seg_compactor(cfg)
    segs = {}
    last = []
    S = cfg.seg_size
    cuda = device.type == "cuda"

    def transcode(sh, pb, inp, comp, mode, meter=None, progress=None):
        with (meter.span if meter else no_span)("transcode"):
            return _transcode(sh, pb, inp, comp, mode, meter, progress)

    def _transcode(sh, pb, inp, comp, mode, meter, progress):
        sp = meter.span if meter else no_span
        b = int(inp.shape[0])
        parts = [[] for _ in range(b)]

        def drain(pend):
            ev, e32, c32, ring = pend
            with sp("wait", "device"):
                if ev is not None:
                    ev.synchronize()
                if ring is not None:
                    meter.add_replays(seg.replay_ms(ring))
            with sp("compact", "host"):
                seg_out, seg_len = compact(e32.numpy(), c32.numpy())
                for i in range(b):
                    parts[i].append(seg_out[i, :seg_len[i]].tobytes())

        with torch.no_grad():
            cd = init_coder(b, device)
            comp = torch.as_tensor(np.asarray(comp), device=device)
            mode = torch.as_tensor(np.broadcast_to(
                np.asarray(mode, dtype=np.int64), (b,)).copy(),
                device=device)
            c4 = comp[:, :4].long()
            xc = (c4[:, 0] << 24) | (c4[:, 1] << 16) | (c4[:, 2] << 8) \
                | c4[:, 3]
            cd["xc"] = torch.where(mode == MODE_DECODE, xc, cd["xc"])
            cd["rptr"] = torch.where(mode == MODE_DECODE, 4, 0)
            inp_T = torch.as_tensor(np.ascontiguousarray(
                np.asarray(inp).T), device=device)
            key = (b, meter is not None)
            if key not in segs:
                segs[key] = make_segment_fn(cfg, g, device, graph, comm,
                                            meter is not None)
            seg = segs[key]
            last[:] = [seg]
            host = [tuple(torch.empty(shape, dtype=torch.int64,
                                      pin_memory=True)
                          for shape in ((S, b, 8), (S, b)))
                    for _ in range(2)] if cuda else None
            with (sp("copyin", "device") if seg.ready
                  else sp("capture", "compile")):
                seg.start(sh, pb, cd, comp, mode)
            pending = None
            for si in range(cfg.block_size // S):
                lo = si * S
                with sp("enqueue", "device"):
                    e32, c32 = seg.run(inp_T[lo:lo + S])
                    if cuda:
                        he, hc = host[si % 2]
                        he.copy_(e32, non_blocking=True)
                        hc.copy_(c32, non_blocking=True)
                        ev = torch.cuda.Event()
                        ev.record()
                        done = (ev, he, hc, seg.ring)
                    else:
                        done = (None, e32, c32, None)
                if pending is not None:
                    drain(pending)
                pending = done
                if meter:
                    meter.add_segment(b * S)
                if progress:
                    progress((si + 1) * S * b)
            drain(pending)
            with sp("readback"):
                _, pb, cd = seg.state()
                x1 = cd["x1"].cpu().numpy()
                hist = pb["hist"].cpu().numpy()
                if seg.timer is not None:
                    meter.add_parts(seg.timer.ms())
        out = np.zeros((b, cfg.comp_size), dtype=np.uint8)
        out_len = np.zeros(b, dtype=np.int64)
        for i in range(b):
            stream = b"".join(parts[i]) + bytes(
                [(int(x1[i]) >> (24 - 8 * j)) & 0xFF for j in range(4)])
            L = min(len(stream), cfg.comp_size)
            out[i, :L] = np.frombuffer(stream[:L], dtype=np.uint8)
            out_len[i] = len(stream)
        return hist, out, out_len

    transcode.state = lambda: last[0].state()
    return transcode


def no_span(name, phase=None):
    """``Meter.span``'s stand-in where no Meter is given."""
    return contextlib.nullcontext()


# ------------------------------------------------------------- pretraining


def make_pretrainer(cfg: EngineConfig, g: Gates, device, graph=True):
    """``(sh, data) -> sh``: replays a training stream (uint8) through the
    full model update at B=1 in encode mode, starting from ``sh`` (its
    tensors updated in place), and throws away the positional state and
    the coder (cf. cmix_tpu/engine.py make_pretrainer).  The stream is
    padded with spaces to whole segments of ``PRETRAIN_SEG`` bytes,
    clamped to the block size as every ``EngineConfig`` clamps its
    segment; byte i runs at position i mod block_size (the JAX package's
    t0 = (si * s) mod block_size of segment si).  The segments run through
    ``make_segment_fn`` (on CUDA one captured graph at B=1; ``graph=False``
    asks for the eager step).  After the replay the match region of
    ``aux_tbl`` is zeroed: its entries point into the discarded
    history."""
    pcfg = dataclasses.replace(cfg, seg_size=PRETRAIN_SEG)

    def pretrain(sh, data):
        data = np.asarray(data, dtype=np.uint8)
        s = pcfg.seg_size
        pad = np.full(-(-len(data) // s) * s, 32, dtype=np.uint8)
        pad[:len(data)] = data
        inp = torch.as_tensor(pad[:, None].copy(), device=device)
        with torch.no_grad():
            seg = make_segment_fn(pcfg, g, device, graph)
            seg.start(sh, init_perblock(pcfg, g, 1, device),
                      init_coder(1, device),
                      torch.zeros((1, 8), dtype=torch.uint8, device=device),
                      torch.zeros(1, dtype=torch.int64, device=device))
            for lo in range(0, len(pad), s):
                seg.run(inp[lo:lo + s], outputs=False)
            sh = seg.state()[0]
            sh["aux_tbl"][:g.mstride * g.n_match * (1 << pcfg.mbits)] = 0
        return sh

    return pretrain
