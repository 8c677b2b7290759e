"""serve_mfu: the whole forward's share of the card's peak. Requests
completed in the traced window times the forward's least time at the
published peaks (``counts.Census.least_time_s``: bf16, and the s8 peak
for the int8 configuration's eligible convs), over the window. Moves
serve_clips_per_s."""


def read(rec):
    if rec.get("kind") != "serve" or not rec.get("units") or not rec.get("window_s"):
        return None
    int8 = bool(rec["config"].get("int8"))
    return (100.0 * rec["units"] * rec["census"].least_time_s(int8)
            / rec["window_s"])
