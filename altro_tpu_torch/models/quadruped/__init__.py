"""Quadruped (Woofer) trot MPC: configuration, gaits, kinematics, footstep
planner, single-rigid-body dynamics and the MPC problem."""
