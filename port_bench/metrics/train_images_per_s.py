"""Images of the micro-steps completed in the window (over every rank),
over the window's seconds; the window ends when the card has finished."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    return rec["items"] / rec["window_s"]
