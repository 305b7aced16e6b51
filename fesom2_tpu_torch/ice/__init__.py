"""Sea ice: state, mEVP dynamics, FCT advection, thermodynamics and the
coupling to the ocean (the port of ``fesom2_tpu/ice``)."""
