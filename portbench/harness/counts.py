"""Operation and byte counts, and the card's published peaks.

The yardstick of the roofline and MFU metrics: what one byte step of the
model needs, computed from the configuration's shapes alone (never read
from the program).

* ``dmc_fused_bytes``: the least traffic of one ``dmc_fused`` launch, a
  frozen copy of the count in the port's ``chip_smoke.time_level``: 4
  bytes a word for the walk's current node, the descriptors read, the
  valid descriptors written, the visited pointer and count words read and
  the three outputs written.  How many descriptors are valid depends on
  the data; the count takes none (``n_valid=0``), so the bound is the
  least these shapes need and the share read from it is a floor.
* ``step_flops``: the model FLOPs of one byte step over all lanes: the
  LSTM's forward and backward over the horizon and its two advancing
  cells, the three mixer layers' dot products and their weight
  gradients, and the APMs' reads, blend and updates.  Products count 2
  FLOPs a multiply-add; elementwise work (layer norms, activations,
  Adam) is left out.
"""

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12         # H100 SXM float32, outside the tensor cores

N_UX, N_UP = 24, 8              # DMC count / pointer descriptors per lane
TREE = 256                      # byte-tree nodes a step predicts


def dmc_fused_bytes(lanes, levels, n_valid=0):
    """Least bytes one ``dmc_fused`` launch moves at ``lanes`` and walk
    depth ``levels`` (chip_smoke.py's count)."""
    walked = (2 ** (levels - 1) - 1) + 2 ** levels
    outs = 2 ** levels * 2 + 2 ** (levels - 1)
    n_desc = lanes * (2 * N_UX + 4 * N_UP)
    return 4 * (lanes + n_desc + n_valid + lanes * (walked + outs))


def lstm_flops(hidden, layers, horizon):
    """FLOPs of one lane's LSTM work in one byte step."""
    gates = 3 * hidden
    emb = 2 * TREE * gates                       # one-hot byte x wx
    # layer 0 reads the embedding, each later layer the one below (wi);
    # every layer its own state (wh)
    cell = emb + (2 * layers - 1) * 2 * hidden * gates
    logits = 2 * layers * hidden * TREE
    fwd = cell + logits
    # backward: input and weight gradients of every product, the
    # embedding's weight gradient only (its one-hot input has none)
    bwd = 2 * (fwd - emb) + emb
    return horizon * (fwd + bwd) + 2 * cell + logits


def mixer_flops(n_inputs, n_mix1, m2in, n_l2, n_apm):
    """FLOPs of one lane's mixers and APMs in one byte step (all 256
    nodes of the byte tree; the APMs' updates at the 8 coded nodes)."""
    l1 = 2 * n_inputs * TREE * n_mix1
    l2 = 2 * m2in * TREE * n_l2
    l3 = 2 * n_l2 * TREE
    apm_read = 3 * n_apm * TREE
    blend = 2 * (1 + n_apm) * TREE
    apm_update = 2 * 2 * n_apm * 8
    # forward and weight gradient of each layer and of the blend
    return 2 * (l1 + l2 + l3 + blend) + apm_read + apm_update


def step_flops(cfg, sizes, lanes):
    """FLOPs of one byte step at ``lanes``: ``cfg`` a configuration
    mapping (lstm_hidden, lstm_layers, lstm_horizon), ``sizes`` the
    ensemble's sizes (n_inputs, n_mix1, m2in, n_l2, n_apm)."""
    per_lane = mixer_flops(**sizes)
    if cfg["lstm_hidden"]:
        per_lane += lstm_flops(cfg["lstm_hidden"], cfg["lstm_layers"],
                               cfg["lstm_horizon"])
    return lanes * per_lane


def ensemble_sizes(gates):
    """The mixer and APM sizes of a gate set, from the reference's own
    derivation of the ensemble (the same rules as the program's)."""
    from portbench.reference.engine import make_gates
    g = make_gates(gates)
    return dict(n_inputs=g.n_inputs, n_mix1=g.n_mix1, m2in=g.m2in,
                n_l2=g.n_l2, n_apm=g.n_apm)
