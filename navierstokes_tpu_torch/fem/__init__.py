"""Reference elements, quadrature and the Taylor-Hood P2/P1 space."""
