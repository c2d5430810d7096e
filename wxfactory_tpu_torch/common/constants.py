"""Physical constants and state-vector variable indices.

Mirrors the capability of the reference's ``wx_factory/common/definitions.py``
(values are standard atmospheric-science constants, identical by necessity
for numerical parity).
"""

NUM_PANELS = 6  # faces of the cubed sphere

DAY_IN_SECS = 24.0 * 3600.0

GRAVITY = 9.80616  # gravitational acceleration [m s^-2]

P0 = 100000.0  # reference pressure [Pa]
RD = 287.05  # gas constant, dry air [J K^-1 kg^-1]
CPD = 1005.46  # specific heat, constant pressure [J K^-1 kg^-1]
CVD = CPD - RD  # specific heat, constant volume [J K^-1 kg^-1]
KAPPA = RD / CPD
HEAT_CAPACITY_RATIO = CPD / CVD  # gamma
INV_P0 = 1.0 / P0
RD_INV_P0 = RD / P0

# Shallow-water state indices: Q = [h, h*u1, h*u2]
IDX_H = 0
IDX_HU1 = 1
IDX_HU2 = 2
# (advection-only SW cases store velocities directly)
IDX_U1 = 1
IDX_U2 = 2

# 3D Euler state indices: Q = [rho, rho*u1, rho*u2, rho*w, rho*theta, ...tracers]
IDX_RHO = 0
IDX_RHO_U1 = 1
IDX_RHO_U2 = 2
IDX_RHO_W = 3
IDX_RHO_THETA = 4

# 2D Cartesian Euler state indices: Q = [rho, rho*u, rho*w, rho*theta]
IDX_2D_RHO = 0
IDX_2D_RHO_U = 1
IDX_2D_RHO_W = 2
IDX_2D_RHO_THETA = 3
