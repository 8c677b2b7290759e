"""train_mfu: the frozen-backbone step's share of the card's bf16 peak:
steps completed in the traced window times the step's least time
(``counts.Census.train_least_time_s``: the forward and the fusion's
backward), over the window. Moves train_clips_per_s."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("units") or not rec.get("window_s"):
        return None
    return (100.0 * rec["units"] * rec["census"].train_least_time_s()
            / rec["window_s"])
