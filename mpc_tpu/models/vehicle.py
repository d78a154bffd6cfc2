"""Vehicle parameter tables and registry.

Replacement for the reference's dependency on the CommonRoad
``vehiclemodels`` package (reference: ``MPC_Planner/configuration.py:7-8`` imports
``parameters_vehicle2``; bounds consumed at ``MPC_Planner/optimizer.py:36-46``).

Instead of ``eval()``-ing a config string into a package constructor
(reference ``configuration.py:458``), vehicles are plain frozen dataclasses in a
registry keyed by name.  All values are compile-time Python floats so they bake
into the XLA program as constants.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class SteeringParams:
    min: float
    max: float
    v_min: float
    v_max: float


@dataclasses.dataclass(frozen=True)
class LongitudinalParams:
    v_min: float
    v_max: float
    v_switch: float
    a_max: float


@dataclasses.dataclass(frozen=True)
class TireParams:
    p_dy1: float  # peak lateral friction coefficient mu
    p_ky1: float  # cornering-stiffness coefficient


@dataclasses.dataclass(frozen=True)
class VehicleParams:
    """Parameters of a single vehicle model.

    Field names mirror the reference's ``p.*`` access paths so constraint code
    reads the same way (``p.steering.min`` etc., reference ``optimizer.py:37-46``).
    """

    name: str
    l: float      # overall length [m]
    w: float      # overall width [m]
    m: float      # mass [kg]
    I_z: float    # yaw inertia [kg m^2]
    a: float      # distance front axle -> CoG [m]
    b: float      # distance rear axle -> CoG [m]
    h_s: float    # CoG height [m]
    steering: SteeringParams
    longitudinal: LongitudinalParams
    tire: TireParams

    @property
    def wheelbase(self) -> float:
        """l_wb = a + b (reference ``configuration.py:343, 364``)."""
        return self.a + self.b


# BMW 320i ("vehicle 2" in the CommonRoad vehicle-model tables).  The bounds
# are the ones the reference reads at optimizer.py:37-46: delta in +-1.066,
# deltaDot in +-0.4, v_max 50.8, a_max 11.5; wheelbase a+b = 2.578... matches
# the YAML-configured wheelbase 2.578 (test/config_files/*.yaml).
VEHICLE_2 = VehicleParams(
    name="parameters_vehicle2",
    l=4.508,
    w=1.610,
    m=1093.3,
    I_z=1791.6,
    a=1.1561957064,
    b=1.4227170936,
    h_s=0.6137735657,
    steering=SteeringParams(min=-1.066, max=1.066, v_min=-0.4, v_max=0.4),
    longitudinal=LongitudinalParams(v_min=-13.6, v_max=50.8, v_switch=7.319,
                                    a_max=11.5),
    tire=TireParams(p_dy1=1.0489, p_ky1=-21.92),
)

_REGISTRY: Dict[str, VehicleParams] = {
    "parameters_vehicle2": VEHICLE_2,
    "vehicle2": VEHICLE_2,
}


def register_vehicle(params: VehicleParams) -> None:
    _REGISTRY[params.name] = params


def get_vehicle(name: str) -> VehicleParams:
    """Registry lookup replacing the reference's ``eval(vehicle_model)()``
    (``configuration.py:458``)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown vehicle model '{name}'. Registered: {sorted(_REGISTRY)}"
        ) from None
