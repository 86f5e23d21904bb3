"""GPU machine constants for the stream-ECM model (per card).

The counterpart of the reference's ``TPUMachineModel``
(``repro/core/machine.py``).  The hierarchy the port's kernels see is
registers <- shared memory <- L2 <- HBM; the SM takes the place of the
paper's core.  What the device reports about itself is read from it
(:meth:`GPUMachineModel.from_device`); the peak rates come from the
vendor's data sheet, chosen by card name, and are listed in ``priors``.
The calibration (``core/calibrate.py``) measures what the card sustains
and keeps it beside the priors: ``measured_bw`` per kernel, the L2
plateau ``l2_bytes_per_s``, a fitted ``l2_bytes``, the RFO verdict
``write_allocate`` and the chip power ``power`` (a :class:`ChipPower`
fitted from the card's own energy counter, its prior chosen by card name
from :data:`POWER_PRIORS`).  The port sets no clock, so a card runs at
one, ``clock_hz``: the reference's frequency fields (``f_steps_ghz``,
``bw_freq_coupled``, ``coupling_floor``) have nothing to hold, and the
energy grids run at :attr:`GPUMachineModel.nominal_ghz` only.
Predictions read ``sustained_bw``; bounds keep the data-sheet
``hbm_bytes_per_s``, the card's limit.

A fitted machine is saved as a versioned machine file
(:func:`save_machine_file`); the port has no machine registry.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path

#: Data-sheet rates by card name, as ``torch.cuda.get_device_name`` gives
#: it: HBM bytes/s, FP32 FLOP/s outside the tensor cores, dense bf16
#: FLOP/s on the tensor cores, the boost clock that links the rates to
#: cycles, the NVLink bytes/s a card sends each way (the counterpart
#: of the reference's ``ici_link_bytes_per_s * ici_links_per_chip``) and
#: the network bytes/s a card sends each way to another node (the
#: reference's ``dcn_bytes_per_s``, the mesh's ``pod`` axis).
#: H100 SXM: NVIDIA H100 data sheet (3.35 TB/s HBM3, 67 TFLOP/s FP32 =
#: 132 SMs x 128 lanes x 2 x 1.98 GHz, 989 TFLOP/s bf16 dense, 900 GB/s
#: NVLink = 18 links x 25 GB/s x 2 directions, so 450 GB/s each way); the
#: network from the DGX H100's eight ConnectX-7 NDR ports for its eight
#: cards, one 400 Gb/s port a card: 50 GB/s each way.
DATASHEET: dict[str, dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "peak_f32_flops": 67e12,
        "peak_bf16_tensor_flops": 989e12,
        "clock_hz": 1.98e9,
        "nvlink_bytes_per_s": 450e9,
        "net_bytes_per_s": 50e9,
    },
}

_PRIOR_FIELDS = ("hbm_bytes_per_s", "peak_f32_flops", "peak_bf16_tensor_flops",
                 "clock_hz", "nvlink_bytes_per_s", "net_bytes_per_s")
#: the fabric rates: data-sheet priors that nothing fits, filled from
#: :data:`DATASHEET` when a machine file written before them is loaded
_FABRIC_FIELDS = ("nvlink_bytes_per_s", "net_bytes_per_s")


@dataclass(frozen=True)
class ChipPower:
    """Chip power as a function of active SMs and frequency (GHz):
    ``P(n, f) = idle + n * (static + lin * f + quad * f**2)`` (paper
    §III-D), the reference's ``ChipPower`` with the SM as the core.

    Per-card calibration data, carried on :attr:`GPUMachineModel.power` as
    ``measured_bw`` carries the sustained rates.  There are no defaults:
    the reference's are a Haswell fit, and a card's prior is its own
    (:data:`POWER_PRIORS`)."""

    idle_watts: float
    static_per_core: float        # W per active SM
    dyn_lin: float                # W per SM per GHz
    dyn_quad: float               # W per SM per GHz^2

    def watts(self, n_cores, f_ghz):
        """Power draw; accepts scalars or broadcastable NumPy arrays."""
        return self.idle_watts + n_cores * (
            self.static_per_core + self.dyn_lin * f_ghz
            + self.dyn_quad * f_ghz**2
        )


#: Chip-power priors by card name: a prior, not a measurement; the
#: calibration fits the card's own (``core/calibrate.py`` ``_fit_power``).
#: H100 SXM: ``watts(132, 1.98)`` is the data sheet's 700 W board limit at
#: the boost clock.  The split is this port's assumption: 100 W with no SM
#: active (a guess at the draw of a card that runs no kernel), and each
#: SM's share of the rest taken as 1/5 static (leakage, which grows with
#: the voltage but not the clock), 1/5 linear and 3/5 quadratic in the
#: clock (switching power is C V^2 f, and the voltage rises with the
#: clock along the card's DVFS curve).
_H100_PER_SM = (700.0 - 100.0) / 132          # W an SM at 1.98 GHz
POWER_PRIORS: dict[str, ChipPower] = {
    "NVIDIA H100 80GB HBM3": ChipPower(
        idle_watts=100.0, static_per_core=0.2 * _H100_PER_SM,
        dyn_lin=0.2 * _H100_PER_SM / 1.98,
        dyn_quad=0.6 * _H100_PER_SM / 1.98**2),
}


@dataclass(frozen=True)
class GPUMachineModel:
    """One GPU as the stream-ECM model sees it.

    ``exposed_hbm_fraction`` is the Eq. 1 overlap coefficient of the
    reference's TPU model; it stays at its prior here: the one-CTA
    depth-1/depth-2 pair that estimates it describes one SM, not the
    card, and is reported beside the model instead of stored in it.

    Calibration fields: ``measured_bw`` maps a kernel name, or the family
    keys ``_stream`` / ``_stencil``, to the HBM bytes/s it sustains;
    ``l2_bytes_per_s`` is the card-wide L2 plateau (``None`` until
    measured); ``write_allocate`` says whether a store reads its line
    first (an RFO stream).  With an empty ``measured_bw`` every
    prediction takes the data-sheet rate, as before calibration.

    ``power`` is the chip power over the SMs (§III-D): the card's prior
    from :data:`POWER_PRIORS` until the calibration fits it.

    ``nvlink_bytes_per_s`` (the ``data`` and ``model`` axes of a mesh)
    and ``net_bytes_per_s`` (its ``pod`` axis) are data-sheet priors that
    nothing fits (one card has no link to measure); a machine file
    written without them loads with the card's prior.
    ``exposed_link_fraction`` is the share of the collectives' time
    serialized with compute (the reference's ``exposed_ici_fraction``),
    prior 1.0: the port's data-parallel step reduces its gradients after
    the backward, on the compute stream (``dist/collectives.py``).
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
    power: ChipPower
    fp32_lanes_per_sm: int = 128
    priors: tuple[str, ...] = _PRIOR_FIELDS
    exposed_hbm_fraction: float = 0.0
    measured_bw: dict = field(default_factory=dict)
    l2_bytes_per_s: float | None = None
    write_allocate: bool = False
    nvlink_bytes_per_s: float | None = None
    net_bytes_per_s: float | None = None
    exposed_link_fraction: float = 1.0

    @classmethod
    def from_device(cls, device) -> "GPUMachineModel":
        """Read the card's own properties; take the rates from DATASHEET.

        Raises ``ValueError`` on a card the data-sheet table or the
        power priors do not know, rather than guessing its rates or its
        power.
        """
        import torch

        props = torch.cuda.get_device_properties(device)
        rates = DATASHEET.get(props.name)
        if rates is None:
            raise ValueError(
                f"no data-sheet rates for {props.name!r}; known cards: "
                f"{sorted(DATASHEET)}")
        if props.name not in POWER_PRIORS:
            raise ValueError(
                f"no power prior for {props.name!r}; known cards: "
                f"{sorted(POWER_PRIORS)}")
        return cls(
            name=props.name,
            sm_count=props.multi_processor_count,
            l2_bytes=props.L2_cache_size,
            memory_bytes=props.total_memory,
            smem_per_block_optin=props.shared_memory_per_block_optin,
            power=POWER_PRIORS[props.name],
            **rates,
        )

    def hbm_seconds(self, nbytes: float) -> float:
        return nbytes / self.hbm_bytes_per_s

    def compute_seconds(self, flops: float) -> float:
        return flops / self.peak_f32_flops

    def hbm_bytes_per_cycle(self) -> float:
        return self.hbm_bytes_per_s / self.clock_hz

    def sustained_bw(self, *keys: str, default: float | None = None) -> float:
        """Walk a calibration-key chain (kernel name, then family key, then
        ``_default``) through :attr:`measured_bw`; where none is present,
        ``default`` or, without one, the data-sheet ``hbm_bytes_per_s``."""
        for k in (*keys, "_default"):
            if k in self.measured_bw:
                return self.measured_bw[k]
        return self.hbm_bytes_per_s if default is None else default

    @property
    def nominal_ghz(self) -> float:
        """The SM clock in GHz (the ECM models' clock domain)."""
        return self.clock_hz / 1e9

    def frequency_grid(self) -> tuple[float, ...]:
        """Clocks of the energy and EDP grids: the card's one clock."""
        return (self.nominal_ghz,)


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
    power=POWER_PRIORS["NVIDIA H100 80GB HBM3"],
    **DATASHEET["NVIDIA H100 80GB HBM3"],
)


#: Version of the machine-file schema; a file of another schema is
#: rejected, not guessed at.  2: the ``power`` field.
MACHINE_SCHEMA_VERSION = 2
#: ``kind`` of a port machine file (the reference's files are
#: ``ecm-machine``; neither package reads the other's)
MACHINE_FILE_KIND = "gpu-machine"


def machine_to_dict(machine: GPUMachineModel) -> dict:
    """A JSON-ready dict of every field; the inverse of
    :func:`machine_from_dict`."""
    d = dataclasses.asdict(machine)
    d["priors"] = list(d["priors"])
    d["measured_bw"] = dict(d["measured_bw"])
    return d


def machine_from_dict(data: dict) -> GPUMachineModel:
    """Rebuild a :class:`GPUMachineModel` from :func:`machine_to_dict`'s
    output or from a whole machine-file document.  Unknown fields, a
    foreign ``kind`` and another schema version raise ``ValueError``."""
    if not isinstance(data, dict):
        raise TypeError(f"machine_from_dict wants a dict, got {type(data)!r}")
    d = dict(data)
    if isinstance(d.get("machine"), dict):            # whole file document
        if d.get("schema") != MACHINE_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported machine-file schema {d.get('schema')!r} (this "
                f"code understands schema {MACHINE_SCHEMA_VERSION})")
        if d.get("kind") != MACHINE_FILE_KIND:
            raise ValueError(f"not a {MACHINE_FILE_KIND!r} file: kind "
                             f"{d.get('kind')!r}")
        d = dict(d["machine"])
    known = {f.name for f in dataclasses.fields(GPUMachineModel)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown GPUMachineModel fields: {unknown}")
    if "priors" in d:
        d["priors"] = tuple(d["priors"])
    if "measured_bw" in d:
        d["measured_bw"] = {k: float(v) for k, v in d["measured_bw"].items()}
    if "power" in d:
        d["power"] = ChipPower(**{k: float(v) for k, v in d["power"].items()})
    rates = DATASHEET.get(d.get("name"), {})
    for k in _FABRIC_FIELDS:
        if d.get(k) is None and k in rates:
            d[k] = rates[k]
    return GPUMachineModel(**d)


def save_machine_file(machine: GPUMachineModel, path: "str | os.PathLike",
                      *, provenance: dict | None = None) -> Path:
    """Write ``machine`` as a versioned machine file; ``provenance`` (the
    calibration's fits, residuals and measurement hash) is stored beside
    it verbatim."""
    doc = {"schema": MACHINE_SCHEMA_VERSION, "kind": MACHINE_FILE_KIND,
           "machine": machine_to_dict(machine)}
    if provenance is not None:
        doc["provenance"] = dict(provenance)
    path = Path(path)
    path.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    return path


def load_machine_file(path: "str | os.PathLike", *,
                      with_provenance: bool = False):
    """Load a machine file; the :class:`GPUMachineModel`, or ``(model,
    provenance)`` with ``with_provenance=True``."""
    raw = json.loads(Path(path).read_text())
    if not isinstance(raw, dict) or not isinstance(raw.get("machine"), dict):
        raise ValueError(f"{os.fspath(path)!r} is not a machine file: expected "
                         f"a JSON object with a 'machine' member")
    model = machine_from_dict(raw)
    if with_provenance:
        return model, dict(raw.get("provenance") or {})
    return model
