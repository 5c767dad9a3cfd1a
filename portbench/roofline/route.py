"""The least bytes one round's route needs (``csrc/route.cu``: the walk
and the receive kernels).

Counted from what these inputs need, not from the buffers' sizes, so a
router that writes only the occupied slots reads at most 100%:

* the valid, unsuppressed messages' ten wire words (type, destination,
  term, log term, log index, commit, reject, hint, hint high, entries);
* each row's count and suppress words and the four row scalars it reads
  (replica id, first and last index, role);
* each row's peer ids and its two route tables;
* the next inbox's slot-type plane, every slot (an empty slot must read
  as empty);
* the other words of the next inbox's occupied slots only (9 header
  words, E entry terms and E config-change bits);
* the ring words (term, config-change bit) of each entry that a
  delivered REPLICATE carries.

The whole next inbox is not counted: that is what keeps a sparser writer
under 100%.
"""
from __future__ import annotations

import torch

KERNELS = ("route_walk_kernel", "route_recv_kernel")

MT_REPLICATE = 4
F_MTYPE, F_N_ENTRIES = 0, 9
WIRE_WORDS = 10
ROW_WORDS = 6


def round_bytes(rec: dict) -> int:
    """Bytes for the round recorded in ``rec`` (the reference's ``out``,
    ``delivered``, ``state_out`` and ``inbox_out``)."""
    out, delivered, st, ib = rec["out"], rec["delivered"], rec["state_out"], rec["inbox_out"]
    G, O, _ = out.buf.shape
    P = st.peer_id.shape[1]
    E = ib.ent_term.shape[2]
    valid = torch.arange(O, device=out.buf.device)[None, :] < out.count[:, None]
    valid &= (out.escalate == 0)[:, None]
    msgs = int(valid.sum())
    repl = delivered & (out.buf[:, :, F_MTYPE] == MT_REPLICATE)
    ring = 2 * int(torch.where(repl, out.buf[:, :, F_N_ENTRIES].clamp(0, E), 0).sum())
    occupied = int((ib.mtype != 0).sum())
    words = (msgs * WIRE_WORDS + G * ROW_WORDS + G * P * 3
             + ib.mtype.numel() + occupied * (9 + 2 * E) + ring)
    return 4 * words
