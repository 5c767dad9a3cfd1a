// raft_step_internal: the raft step in the internal G-last layout.
//
// Replaces dragonboat_tpu/ops/kernel.py `step_internal` (kernel.py:1674)
// without transposes around the external kernel.  The row logic is
// raft_step.cu's, compiled here a second time with DBT_STEP_GL set: every
// per-row array ([P, G], [W, G], inbox [M, G] / [M, E, G], out.buf
// [O, N_FIELDS, G], need_snapshot [P, G], slot_base / slot_term [M, G],
// ent_drop [M, E, G]) is read and written as a[k * G] from the row's
// first element, so the threads of a warp (consecutive rows) touch
// consecutive words of every array.  A translation unit of its own keeps
// the external kernel's compilation as it is.
#define DBT_STEP_GL 1
#include "raft_step.cu"
