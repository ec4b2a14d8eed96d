from .group import Group, Point, Scalar, hash_points  # noqa: F401
from .weier import WeierstrassGroup, WeierstrassPoint  # noqa: F401
from .edwards import TEdwards, TEdwardsPoint  # noqa: F401
from .instances import ALL_GROUPS, group_by_name, p256, tomEdwards256, war256  # noqa: F401
from .multimult import MultiMult, Relation, set_msm_backend  # noqa: F401
