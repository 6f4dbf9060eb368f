"""Sequence packing for LM training batches.  Port of
cosyvoice_tpu/train/packing.py (pure numpy; the port keeps its own copy).

Short utterances dominate TTS corpora, so one example a row leaves most of
each row as padding.  The packer bins whole [sos, text, task, speech]
examples into fixed-length rows (first fit, longest first) for
Qwen2LM.packed_call, whose block-diagonal causal attention keeps every
example's loss terms as they are unpacked.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

PAD, TEXT, SPECIAL, SPEECH = 0, 1, 2, 3


def pack_llm_examples(examples: Sequence[tuple], row_len: int, sos_eos: int = 0,
                      task_id: int = 1, eos_token: Optional[int] = None,
                      ignore_id: int = -1, n_rows: Optional[int] = None) -> dict:
    """Pack (text_ids, speech_ids) examples into [n_rows, row_len] int32
    arrays: ids, types (0 pad, 1 text, 2 sos/task, 3 speech), positions
    (restarting at each example), seg (1-based example id, 0 pad) and
    target (the speech tokens shifted by one, then EOS; ignore_id
    elsewhere), plus n_tokens, the count of non-pad positions.  An example
    longer than row_len raises."""
    assert eos_token is not None, "pass cfg.eos_token"
    lens = [2 + len(t) + len(s) for t, s in examples]
    assert max(lens) <= row_len, (max(lens), row_len)
    rows: list = []           # [used, [example indices]]
    for i in np.argsort(lens)[::-1]:
        for r in rows:
            if r[0] + lens[i] <= row_len:
                r[0] += lens[i]
                r[1].append(i)
                break
        else:
            rows.append([lens[i], [i]])
    if n_rows is not None:
        assert len(rows) <= n_rows, (len(rows), n_rows)
        rows += [[0, []] for _ in range(n_rows - len(rows))]
    B = len(rows)
    ids = np.zeros((B, row_len), np.int32)
    types = np.zeros((B, row_len), np.int32)
    positions = np.zeros((B, row_len), np.int32)
    seg = np.zeros((B, row_len), np.int32)
    target = np.full((B, row_len), ignore_id, np.int32)
    n_tokens = 0
    for b, (_, idxs) in enumerate(rows):
        at = 0
        for si, i in enumerate(idxs, start=1):
            t = np.asarray(examples[i][0], np.int32)
            s = np.asarray(examples[i][1], np.int32)
            tl, sl = len(t), len(s)
            L = 2 + tl + sl
            ids[b, at], types[b, at] = sos_eos, SPECIAL
            ids[b, at + 1: at + 1 + tl], types[b, at + 1: at + 1 + tl] = t, TEXT
            ids[b, at + 1 + tl], types[b, at + 1 + tl] = task_id, SPECIAL
            ids[b, at + 2 + tl: at + L], types[b, at + 2 + tl: at + L] = s, SPEECH
            positions[b, at: at + L] = np.arange(L)
            seg[b, at: at + L] = si
            # position p predicts token p + 1: the speech targets start at
            # the task position, EOS at the last speech position
            target[b, at + 1 + tl: at + 1 + tl + sl] = s
            target[b, at + 1 + tl + sl] = eos_token
            at += L
            n_tokens += L
    return {"ids": ids, "types": types, "positions": positions, "seg": seg,
            "target": target, "n_tokens": n_tokens}


def packed_llm_loss_fn(model, batch: dict, gen=None):
    """Loss over a packed batch for train.step.make_train_step."""
    out = model.packed_call(batch["ids"], batch["types"], batch["positions"], batch["seg"],
                            batch["target"])
    return out["loss"], {"acc": out["acc"], "denom": out["denom"]}
