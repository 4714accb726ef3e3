"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): the rates a roofline share and an MFU are taken against."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HALF_TYPES = ("c10::BFloat16", "c10::Half")


def op_peak(op) -> float:
    """The FLOP rate of a traced op, by the dtype of its first tensor input."""
    kinds = [k for k in op.args.get("Input type", [])
             if k in HALF_TYPES or k == "float"]
    return FLOPS["bfloat16" if kinds and kinds[0] in HALF_TYPES
                 else "float32"]
