"""Woofer robot and MPC controller configuration (PyTorch port's copy of
``altro_tpu/models/quadruped/config.py``: the same published Woofer
parameters and MPC.yaml defaults, as plain numpy, and the same YAML
loaders). The loaders import PyYAML when they are called, so that nothing
else needs it."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class InertialConfig:
    frame_mass: float = 3.0
    module_mass: float = 1.033
    upper_link_mass: float = 0.070
    lower_link_mass: float = 0.059
    body_ix: float = 0.025
    body_iy: float = 0.854
    body_iz: float = 0.897

    @property
    def leg_mass(self):
        return (self.upper_link_mass + self.lower_link_mass) * 2

    @property
    def robot_mass(self):
        return self.frame_mass + 4 * self.module_mass + 4 * self.leg_mass

    @property
    def sprung_mass(self):
        return self.frame_mass + 4 * self.module_mass + 8 * self.upper_link_mass

    @property
    def body_inertia(self):
        return np.diag([self.body_ix, self.body_iy, self.body_iz])


@dataclasses.dataclass(frozen=True)
class ActuatorConfig:
    max_joint_torque: float = 12.0
    max_leg_force: float = 133.0
    revolute_range: float = 3.0


@dataclasses.dataclass(frozen=True)
class GeometryConfig:
    hip_center_y: float = 0.109
    hip_center_x: float = 0.230
    abduction_offset: float = 0.064
    foot_radius: float = 0.02
    body_length: float = 0.66
    body_width: float = 0.176
    body_height: float = 0.092
    upper_link_length: float = 0.18
    lower_link_length: float = 0.32

    @property
    def hip_layout(self):
        """Rows: front-right, front-left, back-right, back-left."""
        x, y = self.hip_center_x, self.hip_center_y
        return np.array([[x, -y, 0.0], [x, y, 0.0], [-x, -y, 0.0],
                         [-x, y, 0.0]])

    @property
    def abduction_layout(self):
        a = self.abduction_offset
        return np.array([-a, a, -a, a])

    @property
    def feet_layout(self):
        lay = self.hip_layout.copy()
        lay[:, 1] += self.abduction_layout
        return lay


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Controller config (MPC.yaml)."""

    N: int = 15
    dynamics_discretization: float = 0.03
    update_dt: float = 0.03
    footstep_replan: float = 0.005
    mu: float = 0.5
    min_vert_force: float = 0.0
    max_vert_force: float = 133.0
    stance_height: float = 0.28
    gait_type: str = "trot"
    stance_time: float = 0.2
    swing_time: float = 0.2
    linearized_friction: bool = True
    solver: str = "ALTRO"
    xy_vel: tuple = (0.0, 0.0)
    omega_z: float = 0.0
    yaw_angle: float = 0.0
    swing_omega: float = 100.0
    swing_zeta: float = 1.0
    step_height: float = 0.05
    q: tuple = (1.0, 1.0, 500.0, 5000.0, 5000.0, 1000.0,
                500.0, 1000.0, 1000.0, 500.0, 500.0, 100.0)
    r: tuple = (1.0, 1.0, 0.001) * 4


def _load_yaml(path: str) -> dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def mpc_config_from_yaml(path: str) -> MPCConfig:
    """The controller config of an MPC.yaml file (its keys as the
    reference's ControllerParams reads them; a missing key keeps the
    default)."""
    d = _load_yaml(path)
    gait = d.get("gait", {})
    swing = d.get("swing", {})
    return MPCConfig(
        N=d.get("N", 15),
        dynamics_discretization=d.get("dynamics_discretization", 0.03),
        update_dt=d.get("update_dt", 0.03),
        footstep_replan=d.get("footstep_replan", 0.005),
        mu=d.get("mu", 0.5),
        min_vert_force=d.get("min_vert_force", 0.0),
        max_vert_force=d.get("max_vert_force", 133.0),
        stance_height=d.get("stance_height", 0.28),
        gait_type=gait.get("type", "trot"),
        stance_time=gait.get("stance_time", 0.2),
        swing_time=gait.get("swing_time", 0.2),
        linearized_friction=d.get("linearized_friction_constraint", True),
        solver=d.get("solver", "ALTRO"),
        xy_vel=tuple(d.get("xy_vel", (0.0, 0.0))),
        omega_z=d.get("omega_z", 0.0),
        yaw_angle=d.get("yaw_angle", 0.0),
        swing_omega=swing.get("omega", 100.0),
        swing_zeta=swing.get("zeta", 1.0),
        step_height=swing.get("step_height", 0.05),
        q=tuple(d["q"]) if "q" in d else MPCConfig.q,
        r=tuple(d["r"]) if "r" in d else MPCConfig.r,
    )


@dataclasses.dataclass(frozen=True)
class WooferConfig:
    inertial: InertialConfig = dataclasses.field(
        default_factory=InertialConfig)
    actuator: ActuatorConfig = dataclasses.field(
        default_factory=ActuatorConfig)
    geometry: GeometryConfig = dataclasses.field(
        default_factory=GeometryConfig)

    @staticmethod
    def from_yaml(path: str) -> "WooferConfig":
        """The robot config of a Woofer.yaml file (inertial and geometry
        keys by field name, unknown keys ignored; the actuator's three)."""
        d = _load_yaml(path)
        i, g = d.get("inertial", {}), d.get("geometry", {})
        a = d.get("actuator", {})
        return WooferConfig(
            inertial=InertialConfig(**{
                k: v for k, v in i.items()
                if k in InertialConfig.__dataclass_fields__}),
            actuator=ActuatorConfig(
                max_joint_torque=a.get("max_joint_torque", 12.0),
                max_leg_force=a.get("max_leg_force", 133.0),
                revolute_range=a.get("revolute_range", 3.0)),
            geometry=GeometryConfig(**{
                k: v for k, v in g.items()
                if k in GeometryConfig.__dataclass_fields__}),
        )


woofer = WooferConfig()
