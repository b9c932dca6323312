from .bvp import (BVPBlocks, BVPCollocation, BVPCOPLS, BVPModel, BVPShooting,
                  BVPTrapezoid, bvp_block_jacobian, bvp_cop_solve,
                  bvp_problem, discretize)
