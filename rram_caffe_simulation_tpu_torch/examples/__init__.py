"""Example drivers of the port (counterparts of the reference
package's examples/)."""
