"""Set-up seconds: from the process's start to the first timed batch
(imports, kernel build or load, weights, warm-up, and for training the
trainer's entry into its state and its first applies)."""


def read(rec):
    return rec["setup_s"]
