"""Evaluation loop: greedy loss, WER and CER over a loader (the JAX
package's ``train/evaluate.py``).

Per-utterance WER/CER via ``get_cer_wer``, aggregated two ways
(reference test.py:197-209): token-weighted (sum of distances / sum of
reference lengths) and averaged over utterances; the loss is the mean of
the batch losses weighted by their real rows (train.py:400), with the
reporting clamp of a non-finite loss to 1000 (train.py:359-362). With
``update_curriculum`` each scored utterance's CER and WER go into
``dataset``'s curriculum store (reference train.py:376-381). Sharded
validation (``all_reduce``): each data shard scores its own bins and the
nine counters are summed over the data group in float64, so every rank
returns the summary of the whole set (JAX ``evaluate.py:118-128``).
"""

from __future__ import annotations

import numpy as np
import torch

from deepspeech_tpu_torch.metrics import get_cer_wer


def decode_batch_greedy(decoder, metrics: dict, batch: dict, labels):
    """Greedy ids (argmaxed on the device) -> one (transcript, reference,
    wer, cer, wer_ref, cer_ref) per real row."""
    hyps, _ = decoder.decode_ids(metrics["greedy"], metrics["out_lens"])
    targets = np.asarray(batch["targets"])
    target_lengths = np.asarray(batch["target_lengths"])
    valid = np.asarray(batch.get("valid", np.ones(len(hyps))))
    results = []
    for i in range(len(hyps)):
        if valid[i] <= 0:
            continue
        transcript = hyps[i][0]
        reference = labels.render_transcript(
            targets[i, :int(target_lengths[i])])
        results.append((transcript, reference,
                        *get_cer_wer(transcript, reference)))
    return results


def evaluate(loader, eval_step, decoder, labels, to_device, dataset=None,
             update_curriculum: bool = False, all_reduce=None) -> dict:
    """Run ``eval_step`` over ``loader`` (host numpy batches, moved with
    ``to_device``) -> loss, wer, cer, utt_wer, utt_cer, num_utterances.
    ``all_reduce``: a ``parallel.Mesh`` whose data group the counters are
    summed over (the JAX ``all_reduce=True``), or None."""
    loss_sum = loss_count = 0.0
    total = np.zeros(4)  # wer, cer, wer_ref, cer_ref
    utt_wer = utt_cer = 0.0
    n_utts = 0
    for batch in loader:
        metrics = eval_step(to_device(batch))
        n_valid = float(np.asarray(batch["valid"]).sum())
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            loss = 1000.0
        loss_sum += loss * n_valid
        loss_count += n_valid
        results = decode_batch_greedy(decoder, metrics, batch, labels)
        for i, (transcript, reference, w, c, wr, cr) in enumerate(results):
            if update_curriculum and dataset is not None:
                dataset.update_curriculum(batch["paths"][i], reference,
                                          transcript, None, c / cr, w / wr)
            total += (w, c, wr, cr)
            utt_wer += w / wr
            utt_cer += c / cr
            n_utts += 1
    if all_reduce is not None:
        counters = torch.tensor(
            [*total, loss_sum, loss_count, utt_wer, utt_cer, n_utts],
            dtype=torch.float64, device=all_reduce.device)
        counters = all_reduce.all_reduce(counters, "data", tag="eval")
        *total, loss_sum, loss_count, utt_wer, utt_cer, n_utts = (
            counters.tolist())
        total, n_utts = np.asarray(total), int(n_utts)
    return {
        "loss": loss_sum / max(loss_count, 1),
        "wer": 100.0 * total[0] / max(total[2], 1.0),
        "cer": 100.0 * total[1] / max(total[3], 1.0),
        "utt_wer": 100.0 * utt_wer / max(n_utts, 1),
        "utt_cer": 100.0 * utt_cer / max(n_utts, 1),
        "num_utterances": n_utts,
    }
