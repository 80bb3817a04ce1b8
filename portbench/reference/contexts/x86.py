"""x86 instruction-structure contexts, batched over blocks.

Port of cmix_tpu/contexts/x86.py: the same coarse decoder state machine
(LUTs built procedurally from x86 encoding rules), advanced once per byte
for every block.  The state is updated on every byte whatever the X86X gate
says, because ``x86_ctx_vals`` feeds the bank and the mixer gates; the
opcode-stream values ``x86_ext_vals`` (X86X >= 1) and ``x86_ext_vals2``
(X86X = 2) read the same state.
"""

import numpy as np
import torch

from portbench.reference.u32 import M32, mix32, mul


def _build_tables():
    """(is_prefix, has_modrm1, imm1, has_modrm2, imm2, is_jump1) [256]."""
    is_prefix = np.zeros(256, np.int64)
    for b in (0x26, 0x2E, 0x36, 0x3E, 0x64, 0x65, 0x66, 0x67,
              0xF0, 0xF2, 0xF3):
        is_prefix[b] = 1
    m1 = np.zeros(256, np.int64)
    i1 = np.zeros(256, np.int64)
    j1 = np.zeros(256, np.int64)
    for b in range(0x40):
        k = b & 7
        if k < 4:
            m1[b] = 1
        elif k == 4:
            i1[b] = 1
        elif k == 5:
            i1[b] = 4
    m1[0x62] = m1[0x63] = 1
    i1[0x68] = 4
    m1[0x69] = 1
    i1[0x69] = 4
    i1[0x6A] = 1
    m1[0x6B] = 1
    i1[0x6B] = 1
    for b in range(0x70, 0x80):
        i1[b] = 1
        j1[b] = 1
    for b in range(0x80, 0x90):
        m1[b] = 1
    i1[0x80] = i1[0x82] = i1[0x83] = 1
    i1[0x81] = 4
    i1[0x9A] = 6
    for b in (0xA0, 0xA1, 0xA2, 0xA3):
        i1[b] = 4
    i1[0xA8] = 1
    i1[0xA9] = 4
    for b in range(0xB0, 0xB8):
        i1[b] = 1
    for b in range(0xB8, 0xC0):
        i1[b] = 4
    m1[0xC0] = m1[0xC1] = 1
    i1[0xC0] = i1[0xC1] = 1
    i1[0xC2] = 2
    m1[0xC4] = m1[0xC5] = m1[0xC6] = m1[0xC7] = 1
    i1[0xC6] = 1
    i1[0xC7] = 4
    i1[0xC8] = 3
    i1[0xCA] = 2
    i1[0xCD] = 1
    for b in range(0xD0, 0xD4):
        m1[b] = 1
    i1[0xD4] = i1[0xD5] = 1
    for b in range(0xD8, 0xE0):
        m1[b] = 1
    for b in range(0xE0, 0xE4):
        i1[b] = 1
        j1[b] = 1
    for b in (0xE4, 0xE5, 0xE6, 0xE7):
        i1[b] = 1
    i1[0xE8] = i1[0xE9] = 4
    j1[0xE8] = j1[0xE9] = 1
    i1[0xEA] = 6
    i1[0xEB] = 1
    j1[0xEB] = 1
    m1[0xF6] = m1[0xF7] = 1
    m1[0xFE] = m1[0xFF] = 1

    m2 = np.ones(256, np.int64)
    i2 = np.zeros(256, np.int64)
    for b in (0x05, 0x06, 0x07, 0x08, 0x09, 0x0B, 0x0E, 0x30, 0x31,
              0x32, 0x33, 0x34, 0x35, 0x77, 0xA0, 0xA1, 0xA2, 0xA8,
              0xA9, 0xAA):
        m2[b] = 0
    for b in range(0x80, 0x90):
        m2[b] = 0
        i2[b] = 4
    for b in range(0xC8, 0xD0):
        m2[b] = 0
    for b in range(0x70, 0x74):
        i2[b] = 1
    i2[0xA4] = i2[0xAC] = 1
    i2[0xBA] = 1
    for b in range(0xC2, 0xC7):
        i2[b] = 1
    # one packed LUT: bit0 prefix, bit1 modrm1, bits2-4 imm1, bit5 modrm2,
    # bits6-8 imm2, bit9 jump1 -- one gather per byte instead of six
    return is_prefix | (m1 << 1) | (i1 << 2) | (m2 << 5) | (i2 << 6) \
        | (j1 << 9)


X86_LUT = _build_tables()
PH_OP, PH_OP2, PH_MODRM, PH_SIB, PH_TAIL = 0, 1, 2, 3, 4
_KEYS = ("phase", "rem", "pimm", "op", "modrm", "ipos", "opln", "lastjmp",
         "pop", "pop2", "ophist")
_LUT_DEV = {}


def init_x86_state(B, device):
    return {k: torch.zeros(B, dtype=torch.int64, device=device)
            for k in _KEYS}


def x86_update(st, b):
    """Advance the decoder by one byte; st leaves (B,) int64, b (B,)."""
    key = str(b.device)
    if key not in _LUT_DEV:
        _LUT_DEV[key] = torch.as_tensor(X86_LUT, device=b.device)
    w = _LUT_DEV[key][b]
    pfx, m1, i1 = w & 1, (w >> 1) & 1, (w >> 2) & 7
    m2, i2, jj = (w >> 5) & 1, (w >> 6) & 7, (w >> 9) & 1
    phase, rem = st["phase"], st["rem"]
    pimm, op, modrm = st["pimm"], st["op"], st["modrm"]
    ipos, opln = st["ipos"], st["opln"]

    at_op = phase == PH_OP
    at_op2 = phase == PH_OP2
    is_pfx = at_op & (pfx == 1)
    is_esc = at_op & (b == 0x0F) & ~is_pfx
    is_op1 = at_op & ~is_pfx & ~is_esc
    has_m = torch.where(is_op1, m1, m2)
    imm = torch.where(is_op1, i1, i2)
    opc = torch.where(at_op2, b | 0x100, b)
    new_op = torch.where(is_op1 | at_op2, opc, op)

    mod = (b >> 6) & 3
    rm = b & 7
    disp = torch.where(mod == 1, 1, torch.where(
        mod == 2, 4, torch.where((mod == 0) & (rm == 5), 4, 0)))
    need_sib = (rm == 4) & (mod != 3)
    at_mr = phase == PH_MODRM
    at_sib = phase == PH_SIB
    sib_extra = torch.where(((b & 7) == 5) & ((modrm >> 6) == 0), 4, 0)
    at_tail = phase == PH_TAIL

    started = is_op1 | at_op2
    new_pimm = torch.where(started, imm, pimm)
    new_modrm = torch.where(at_mr, b, torch.where(started, 0, modrm))

    nxt = torch.where(
        is_pfx, PH_OP,
        torch.where(is_esc, PH_OP2,
                    torch.where(started,
                                torch.where(has_m == 1, PH_MODRM,
                                            torch.where(imm > 0, PH_TAIL,
                                                        PH_OP)),
                                phase)))
    tail_after_mr = disp + new_pimm
    nxt = torch.where(at_mr, torch.where(
        need_sib, PH_SIB, torch.where(tail_after_mr > 0, PH_TAIL, PH_OP)),
        nxt)
    new_rem = torch.where(started, imm, rem)
    new_rem = torch.where(at_mr, tail_after_mr, new_rem)
    tail_after_sib = rem + sib_extra
    nxt = torch.where(at_sib, torch.where(tail_after_sib > 0, PH_TAIL,
                                          PH_OP), nxt)
    new_rem = torch.where(at_sib, tail_after_sib, new_rem)
    dec = at_tail & (rem > 0)
    new_rem = torch.where(dec, rem - 1, new_rem)
    nxt = torch.where(dec, torch.where(rem - 1 > 0, PH_TAIL, PH_OP), nxt)

    done = nxt == PH_OP
    new_ipos = torch.where(done, 0, torch.clamp(ipos + 1, max=15))
    new_opln = torch.where(started, torch.clamp(ipos + 1, max=15), opln)
    lastjmp = torch.where(started & (jj == 1) & is_op1, 1,
                          torch.where(done, 0, st["lastjmp"]))
    pop = torch.where(started, op, st["pop"])
    pop2 = torch.where(started, st["pop"], st["pop2"])
    ophist = torch.where(
        started, (mul(st["ophist"], 0x2545F491) + opc + 1) & M32,
        st["ophist"])
    return {"phase": nxt, "rem": torch.clamp(new_rem, max=15),
            "pimm": new_pimm, "op": new_op, "modrm": new_modrm,
            "ipos": new_ipos, "opln": new_opln, "lastjmp": lastjmp,
            "pop": pop, "pop2": pop2, "ophist": ophist}


def x86_ctx_vals(st):
    """Context values (B, 4) u32 + mixer gate (B,) in [0, 64)."""
    op, ipos = st["op"], st["ipos"]
    h = torch.stack([op * 16 + ipos, op, st["phase"] * 16 + st["rem"],
                     op * 32 + st["lastjmp"] * 16 + ipos], dim=1)
    x = torch.stack([torch.full_like(op, 0xE8A3C51D), st["modrm"] + 0x200,
                     op & 0xF0, torch.full_like(op, 0x9D5F3A2B)], dim=1)
    gate = (st["phase"] * 16 + torch.clamp(st["rem"], max=15)) & 63
    return mix32(h & M32, x), gate


def x86_ext_vals(st):
    """Opcode-stream contexts (B, 2) u32: the (previous op, op, position)
    bigram and the rolling opcode-history hash crossed with position."""
    h = torch.stack([(st["pop"] * 0x600 + st["op"] * 2
                      + torch.clamp(st["ipos"], max=1)) & M32,
                     st["ophist"]], dim=1)
    x = torch.stack([torch.full_like(h[:, 0], 0x7F4A7C15),
                     (st["ipos"] + 0x61C88647) & M32], dim=1)
    return mix32(h, x)


def x86_ext_vals2(st):
    """Deeper opcode contexts (B, 2) u32, X86X = 2: the opcode trigram and
    (opcode, ModRM reg field, phase)."""
    h = torch.stack([mix32(st["pop2"], (st["pop"] + 0x8F1B) & M32),
                     (st["op"] * 64 + ((st["modrm"] >> 3) & 7) * 8
                      + st["phase"]) & M32], dim=1)
    x = torch.stack([(st["op"] * 4 + torch.clamp(st["ipos"], max=3)) & M32,
                     torch.full_like(h[:, 0], 0xC2B2AE35)], dim=1)
    return mix32(h, x)
