// Device functions of the constrained car with the quadratic slack penalty
// (`models/concar_quad.py`): concar's dynamics and constraints, and the
// stage cost 0.05 (5 u0^2 + u1^2) + 1000 |s-|^2 in place of concar's L1
// penalty 50 sum(s-). theta = the [4, 3] obstacle rows, as concar.

#pragma once

#define CONCAR_QUADRATIC_SLACK_PENALTY 1
#include "concar.cuh"
