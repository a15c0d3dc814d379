"""TPM14xx bad: a consumer reads a field no producer writes, and
another filters on a kind nobody emits."""


def _device_fields(rec, devices):
    rec["devices"] = devices


def mem_record(devices):
    rec = {"kind": "mem", "t": 0.0}
    _device_fields(rec, devices)
    return rec


def summarize(records):
    return [rec.get("bytes_in_use") for rec in records  # expect: TPM1401
            if rec.get("kind") == "mem"]


def count_spam(records):
    n = 0
    for rec in records:
        if rec.get("kind") == "spam":  # expect: TPM1402
            n += 1
    return n
