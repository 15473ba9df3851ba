"""Static analysis of the port's programs: the cost model
(``costmodel``)."""
