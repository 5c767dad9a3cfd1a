"""The least bytes one round's raft step needs (``csrc/raft_step.cu``).

Counted from what these inputs need, not from the buffers' sizes, so a
kernel that writes only what changed, or skips empty slots, still reads
at most 100% of its roofline:

* every state word read once (the step reads each row's whole state);
* the state words that differ between the round's input and output
  (a word that does not change need not be written);
* the inbox's slot-type plane (a row must learn which slots are empty);
* the other words of the occupied slots only (9 header words and the E
  entry terms and E config-change bits);
* the valid outbox messages (11 words each) and one count word a row.

The whole outbox, the unused slot outputs and the empty slots' words
are not counted.
"""
from __future__ import annotations

KERNELS = ("raft_step_kernel",)

N_FIELDS = 11  # outbox words a message


def round_bytes(rec: dict) -> int:
    """Bytes for the round recorded in ``rec`` (the reference's
    ``state_in``, ``inbox_in``, ``state_out`` and ``out``)."""
    st_in, st_out, ib, out = rec["state_in"], rec["state_out"], rec["inbox_in"], rec["out"]
    read_state = sum(t.numel() for t in st_in)
    changed = sum(int((a != b).sum()) for a, b in zip(st_in, st_out))
    E = ib.ent_term.shape[2]
    occupied = int((ib.mtype != 0).sum())
    O = out.buf.shape[1]
    msgs = int(out.count.clamp(0, O).sum())
    words = (read_state + changed + ib.mtype.numel() + occupied * (9 + 2 * E)
             + msgs * N_FIELDS + out.count.numel())
    return 4 * words
