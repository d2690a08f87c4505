"""Images whose detections came back to the host in the window, over the
window's seconds."""


def read(rec):
    if rec.get("kind") != "predict":
        return None
    return rec["items"] / rec["window_s"]
