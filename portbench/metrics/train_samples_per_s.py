"""``train_samples_per_s``: every training sample of every step the
window issued (all complete at its closing ``synchronize``) over the
whole window, validations and checkpoints included."""


def read(rec):
    if not rec.window_s or "samples" not in rec.work:
        return None
    return rec.work["samples"] / rec.window_s
