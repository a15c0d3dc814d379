"""TPM14xx good: a field written through a same-file helper is
produced, and every consumed kind is emitted."""


def _device_fields(rec, devices):
    rec["devices"] = devices
    rec["bytes_in_use"] = sum(devices.values())


def mem_record(devices):
    rec = {"kind": "mem", "t": 0.0}
    _device_fields(rec, devices)
    return rec


def summarize(records):
    out = []
    for rec in records:
        if rec.get("kind") == "mem":
            out.append((rec.get("bytes_in_use"), rec.get("devices")))
    return out
