"""GPU machine constants for the stream-ECM model (per card).

The counterpart of the reference's ``TPUMachineModel``
(``repro/core/machine.py``).  The hierarchy the port's kernels see is
registers <- shared memory <- L2 <- HBM; the SM takes the place of the
paper's core.  What the device reports about itself is read from it
(:meth:`GPUMachineModel.from_device`); the peak rates come from the
vendor's data sheet, chosen by card name, and are listed in ``priors``
because nothing in the port has measured them.
"""
from __future__ import annotations

from dataclasses import dataclass

#: Data-sheet rates by card name, as ``torch.cuda.get_device_name`` gives
#: it: HBM bytes/s, FP32 FLOP/s outside the tensor cores, dense bf16
#: FLOP/s on the tensor cores, and the boost clock that links the rates to
#: cycles.  H100 SXM: NVIDIA H100 data sheet (3.35 TB/s HBM3, 67 TFLOP/s
#: FP32 = 132 SMs x 128 lanes x 2 x 1.98 GHz, 989 TFLOP/s bf16 dense).
DATASHEET: dict[str, dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "peak_f32_flops": 67e12,
        "peak_bf16_tensor_flops": 989e12,
        "clock_hz": 1.98e9,
    },
}

_PRIOR_FIELDS = ("hbm_bytes_per_s", "peak_f32_flops", "peak_bf16_tensor_flops",
                 "clock_hz")


@dataclass(frozen=True)
class GPUMachineModel:
    """One GPU as the stream-ECM model sees it.

    ``exposed_hbm_fraction`` is the Eq. 1 overlap coefficient of the
    reference's TPU model; it stays at its prior here: the one-CTA
    depth-1/depth-2 pair that estimates it describes one SM, not the
    card, and is reported beside the model instead of stored in it.
    """

    name: str
    sm_count: int
    l2_bytes: int
    memory_bytes: int
    smem_per_block_optin: int
    hbm_bytes_per_s: float
    peak_f32_flops: float
    peak_bf16_tensor_flops: float
    clock_hz: float
    fp32_lanes_per_sm: int = 128
    priors: tuple[str, ...] = _PRIOR_FIELDS
    exposed_hbm_fraction: float = 0.0

    @classmethod
    def from_device(cls, device) -> "GPUMachineModel":
        """Read the card's own properties; take the rates from DATASHEET.

        Raises ``ValueError`` on a card the data-sheet table does not
        know, rather than guessing its rates.
        """
        import torch

        props = torch.cuda.get_device_properties(device)
        rates = DATASHEET.get(props.name)
        if rates is None:
            raise ValueError(
                f"no data-sheet rates for {props.name!r}; known cards: "
                f"{sorted(DATASHEET)}")
        return cls(
            name=props.name,
            sm_count=props.multi_processor_count,
            l2_bytes=props.L2_cache_size,
            memory_bytes=props.total_memory,
            smem_per_block_optin=props.shared_memory_per_block_optin,
            **rates,
        )

    def hbm_seconds(self, nbytes: float) -> float:
        return nbytes / self.hbm_bytes_per_s

    def compute_seconds(self, flops: float) -> float:
        return flops / self.peak_f32_flops

    def hbm_bytes_per_cycle(self) -> float:
        return self.hbm_bytes_per_s / self.clock_hz


#: The H100 SXM as its data sheet and the Hopper tuning guide describe it
#: (132 SMs, 50 MB L2, 80 GB HBM3, 227 KB of shared memory per block by
#: opt-in).  Used where no card is present, e.g. by the model's CPU tests;
#: a run on the card builds its model with ``from_device``.
H100_SXM = GPUMachineModel(
    name="NVIDIA H100 80GB HBM3",
    sm_count=132,
    l2_bytes=50 * 1024**2,
    memory_bytes=80 * 1024**3,
    smem_per_block_optin=232448,
    **DATASHEET["NVIDIA H100 80GB HBM3"],
)
