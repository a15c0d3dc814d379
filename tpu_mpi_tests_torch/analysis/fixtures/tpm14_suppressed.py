"""TPM14xx suppressed: a field an older writer emitted, read on
purpose for streams written before it was dropped."""


def mem_record():
    return {"kind": "mem", "t": 0.0}


def summarize(records):
    out = []
    for rec in records:
        if rec.get("kind") == "mem":
            # older streams carry it; new ones take the default
            out.append(rec.get("legacy_bytes"))  # tpumt: ignore[TPM1401]
    return out
