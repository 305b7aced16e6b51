"""Post-processing tools on a run's own files: mesh/result loaders,
regridding, climatology comparison, MOC/TS/curl diagnostics, the FPost
products and the fcheck golden means (the port of ``fesom2_tpu/post``,
which replaces the reference's ``view/`` Python modules and the
``fpost2/`` Fortran post-processor).  Host numpy and scipy."""
from .mesh_loader import PostMesh, load_mesh, read_stream, ind_for_depth, \
    cut_region
from .regrid import lon_lat_to_cartesian, fesom2regular, regular_grid
from .moc import moc_z, moc_dens
from .climatology import Climatology, fesom2clim
from .plot import ftriplot, wplot_xy, wplot_yz, moving_average
