from .axes import (Axis, CylindricalAxes, SphericalAxes,  # noqa: F401
                   default_cylindrical_axes, default_spherical_axes)
from .fits import read_fits, save_table_fits, write_fits  # noqa: F401
from .table import (PhotonTable, ReferenceSource,  # noqa: F401
                    make_reference_source, save_table_npz, tabulate)
